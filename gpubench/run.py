"""The benchmark of tinynerf_tpu_torch: one run of one cell.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's end-to-end metrics (--trace 0) or its per-layer metrics
(--trace 1) as one JSON line, last on standard output, and each number of
the correctness check beside its limit, last on standard error. Exits
with a code other than 0, and prints no result, without a CUDA device (or
fewer than the cell asks for), or when a module of JAX or of the JAX
package is loaded once the window has closed.

    python3 gpubench/run.py --workload <name> --control --seeds 1,2,3

reads the control instead (the plain reference in float8 in the
program's place) and the planted faults, at the cell's own size, against
the float32 reference: the upper readings the limits are set from.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "gpubench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tinynerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--seeds", default="")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench.core import cell
    from gpubench.reference.common import no_tf32

    chips = next((c["chips"] for c in cell.spec()["workloads"] if c["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    no_tf32()
    if args.control:
        from gpubench.core import control

        seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]
        print(json.dumps(control.read(args.workload, seeds, torch.device("cuda", 0))))
        return 0
    out = cell.run(cell.Options(args.workload, args.seed, args.seconds, bool(args.trace)), T0)
    found = forbidden_modules()
    if found:
        print(f"gpubench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    from gpubench.core.check import print_checks

    print_checks(out["checks"])
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device", "window")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
