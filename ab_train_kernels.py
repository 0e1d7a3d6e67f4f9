"""The one-scene training kernels of two checkouts on one CUDA card: K2,
K4, K6 and K7 timed in turn A B B A A B B A, and their results compared bit
for bit. A development tool: nothing of the package imports it.

Each run is a process of its own that imports tinynerf_tpu_torch from its
checkout and builds that checkout's kernels there (build/ under it). The
shapes are chip_smoke.py's one-scene ones: K2 on a 2048-ray step of 64
jittered samples, the reference recipe's TinyNeRF 4 x 128, in f32 and
bf16 (phase 10); K4 on the flagship's coarse pass (2048 rays x 64 jittered
in the kernel, weights and depths out, hidden 256, bf16 and f32; phase 21)
and on the hidden-128 NeRF's fine pass (2048 rays x a 128-sample union);
K6 on the flagship's fine union (2048 x 192, block 64, bf16; phase 21);
K7's forward and backward on the flagship's fine shard (2048 x 96, block
48, bf16; phase 25). Every input is made from a fixed seed, so a kernel
that neither checkout changed gives the same bits in both.

    python ab_train_kernels.py OTHER_CHECKOUT [THIS_CHECKOUT]

(THIS_CHECKOUT defaults to the directory of this file.) Prints the card's
name and power limit, a line a run, then one JSON object: each kernel's
best milliseconds per checkout (the min over its four runs), whether
its results were bit-identical in all eight runs, and each kernel
function's ptxas register line per checkout.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

N_RAYS = 2048
REPEATS = 3  # timings a kernel a run; the run keeps the least


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def worker(tree: str) -> dict:
    """Build and time the kernels of the checkout at `tree` -> {"ms":
    {kernel: ms}, "digest": {kernel: sha256 of its outputs}, "ptxas":
    {kernel function: its ptxas register line}}."""
    sys.path.insert(0, tree)
    import math

    import numpy as np
    import torch

    import tinynerf_tpu_torch
    from tinynerf_tpu_torch.kernels import _build

    if not Path(tinynerf_tpu_torch.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {tinynerf_tpu_torch.__file__}, not the package in {tree}")
    sources = ("fused_train", "fused_nerf_train", "fused_partials")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.build, sources)))
    ptxas = {}
    for lib in libs.values():
        kernel = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:  # the mangled name less its per-build namespace
                kernel = re.sub(r"^.*_cu_[0-9a-f]{8}\d+", "", m.group(1))
            elif "registers" in line and kernel is not None:
                ptxas[kernel] = line.split(":", 1)[-1].strip()

    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads
    from tinynerf_tpu_torch.kernels.fused_partials import (
        fused_block_partials_bwd, fused_block_partials_fwd)
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
    from tinynerf_tpu_torch.ops.encoding import encoding_dim
    from tinynerf_tpu_torch.ops.volume import global_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    ro = torch.from_numpy((rng.randn(N_RAYS, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32))
    rd = rng.randn(N_RAYS, 3).astype(np.float32)
    rd = torch.from_numpy(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    ro, rd = ro.to(dev), rd.to(dev)
    tgt = torch.from_numpy(rng.rand(N_RAYS, 3).astype(np.float32)).to(dev)

    def sorted_z(S, seed):
        z = np.random.RandomState(seed).uniform(2.0, 6.0, (N_RAYS, S)).astype(np.float32)
        return torch.from_numpy(np.sort(z, axis=1)).to(dev)

    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=128, compute_dtype=dtype)
        m = TinyNeRF(cfg, generator=torch.Generator().manual_seed(1), device=dev)
        cases[f"K2 {str(dtype)[6:]}"] = lambda m=m: fused_loss_grads(m, ro, rd, tgt, seed,
                                                                     n_samples=64)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = NeRFConfig(hidden=256, rgb_hidden=128, compute_dtype=dtype)
        mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(2), device=dev)
        cases[f"K4 coarse flagship {str(dtype)[6:]}"] = (
            lambda mlp=mlp: fused_nerf_pass_grads(mlp, ro, rd, tgt, seed, n_samples=64,
                                                  emit_sampling=True))
    bf16 = torch.bfloat16
    cfg128 = NeRFConfig(hidden=128, rgb_hidden=64, compute_dtype=bf16)
    mlp128 = NeRFMLP(cfg128, generator=torch.Generator().manual_seed(3), device=dev)
    z128 = sorted_z(128, 4)
    cases["K4 fine nerf128 bfloat16"] = lambda: fused_nerf_pass_grads(
        mlp128, ro, rd, tgt, seed, z128, randomized=False)
    cfg = NeRFConfig(hidden=256, rgb_hidden=128, compute_dtype=bf16)
    flag = NeRFMLP(cfg, generator=torch.Generator().manual_seed(5), device=dev)
    z192 = sorted_z(192, 6)
    cases["K6 fine flagship bfloat16"] = lambda: fused_nerf_pass_grads_streamed(
        flag, ro, rd, tgt, z192, sample_block=64)
    z96, sb = sorted_z(96, 7), 48
    d96 = global_deltas(z96, rd).contiguous()
    noise = torch.from_numpy(rng.randn(N_RAYS, 96).astype(np.float32)).to(dev)
    tile = 128 // math.gcd(128, sb)
    g_ray = torch.from_numpy((0.5 + rng.rand(N_RAYS, 6)).astype(np.float32) / N_RAYS).to(dev)
    fwd_args = (flag, cfg, ro, rd, z96, d96, noise, sb, tile, False)
    cases["K7 forward fine shard bfloat16"] = lambda: fused_block_partials_fwd(*fwd_args)
    _, tin, _, w_fwd, w_mma = fused_block_partials_fwd(*fwd_args)
    cases["K7 backward fine shard bfloat16"] = lambda: fused_block_partials_bwd(
        flag, cfg, ro, rd, z96, d96, noise, tin, g_ray, None, w_fwd, w_mma, sb, tile)

    def digest(out) -> str:
        h = hashlib.sha256()

        def add(x):
            if isinstance(x, torch.Tensor):
                h.update(x.detach().float().cpu().numpy().tobytes())
            elif isinstance(x, (list, tuple)):
                for y in x:
                    add(y)

        add(out)
        return h.hexdigest()[:16]

    def cuda_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    ms = {name: min(cuda_ms(fn) for _ in range(REPEATS)) for name, fn in cases.items()}
    return {"ms": ms, "digest": {name: digest(fn()) for name, fn in cases.items()},
            "ptxas": ptxas}


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    trees = {"A": os.path.abspath(sys.argv[1]),
             "B": os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else
                                  os.path.dirname(os.path.abspath(__file__)))}
    print(card_line(), flush=True)
    runs = {"A": [], "B": []}
    for which in "ABBAABBA":
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               trees[which]], capture_output=True, text=True, cwd=trees[which])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[which].append(res)
        print(f"[run] {which} ({trees[which]}) in {time.time() - t0:.1f}s: "
              f"{json.dumps(res['ms'])}", flush=True)
    names = list(runs["A"][0]["ms"])
    summary = {
        "trees": trees,
        "ms": {n: {w: min(r["ms"][n] for r in runs[w]) for w in runs} for n in names},
        "bit_identical": {n: len({r["digest"][n] for w in runs for r in runs[w]}) == 1
                          for n in names},
        "ptxas": {w: runs[w][0]["ptxas"] for w in runs},
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
