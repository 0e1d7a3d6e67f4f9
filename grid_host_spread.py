"""The host side of the benchmark cell instant-ngp.train, block by block,
in one process: the rate of each block, and the program's spans a step,
so that runs in several processes show what changes between a fast run
and a slow one once the host paces the step. A development tool: nothing
of the package imports it.

    python3 grid_host_spread.py [--seed N] [--blocks 12]

Builds the cell's training object as gpubench/loops/train.py does (the
same inputs and weights from the seed, one thread for PyTorch's CPU ops),
runs its first block, then times --blocks blocks of 50 steps, each closed
by a sync, as the benchmark's window does. Then it traces one more block
under a CPU-only torch.profiler and reads the program's spans
(utils/profiling.spans) in host milliseconds a step. Prints a line a
block and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CELL = "instant-ngp.train"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=3023000777)
    p.add_argument("--blocks", type=int, default=12)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gpubench.core import cell as C
    from gpubench.loops import train as loop
    from gpubench.reference.common import no_tf32
    from tinynerf_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    no_tf32()
    dev = torch.device("cuda", 0)
    _, cfg, traffic = C.load_cell(CELL)
    system = C.system_of(cfg)
    data, W0, train_seed = loop.inputs(system.reference, cfg, traffic, args.seed, dev)
    prog = system.Train(cfg, traffic, W0, data, train_seed, dev)
    steps = traffic["block_steps"]
    prog.run(0)
    torch.cuda.synchronize(dev)
    rates = []
    for i in range(1, args.blocks + 1):
        w = time.perf_counter()
        prog.run(steps * i)
        torch.cuda.synchronize(dev)
        w = time.perf_counter() - w
        rates.append(round(steps * traffic["rays_per_scene"] / w, 1))
        print(f"[block {i}] {1e3 * w / steps:.4f} ms a step, {rates[-1]} rays/s", flush=True)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        w = time.perf_counter()
        prog.run(steps * (args.blocks + 1))
        torch.cuda.synchronize(dev)
        w = time.perf_counter() - w
    spans = {}
    for (name, _), v in profiling.spans().items():
        spans[name] = spans.get(name, 0.0) + 1e3 * v["total_s"] / steps
    print(json.dumps({
        "seed": args.seed, "rays_per_s_median": statistics.median(rates), "rays_per_s": rates,
        "traced_ms_a_step": round(1e3 * w / steps, 4),
        "span_ms_a_step": {k: round(v, 4) for k, v in spans.items() if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
