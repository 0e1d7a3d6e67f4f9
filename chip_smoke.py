"""Drive the PyTorch + CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed with its result and time:
  1. build    - compile every kernel of the render path from csrc/ (nvcc),
                with the HMMA instructions of each K1 kernel (cuobjdump
                -sass): the bf16 tensor-core kernel (kMma) has them, the
                CUDA-core one none.
  2. kernel   - each kernel against its plain torch version on the card,
                at the main path's shapes (8192 rays from get_rays on a
                synthetic pose, 64 samples, hidden 128), f32 (the CUDA
                cores) and bf16 (the tensor cores, the launch counted).
  3. main     - `tinynerf_tpu_torch.main` in process: untrained model,
                synthetic scene fallback at 100x100, chunk 8192. The image
                must be finite, in [0, 1], agree with the eager render of
                the same model, and the kernel's launch count must rise,
                every launch on the tensor cores (bf16).
  4. make_gif - write a params-only checkpoint, render a 60-frame spiral
                from it with `tinynerf_tpu_torch.make_gif`; count again.
  5. timing   - steady-state time of one 100x100 image and of one
                8192-ray batch through each kernel and its plain version,
                bf16 (the tensor cores) and f32 (the CUDA cores); as a
                reading, K1's per-call weight packing alone.
  6. build    - the train kernel fused_train.cu (its nvcc runs beside
                phase 1's), with ptxas's register and spill counts and
                the HMMA instructions of each K2 kernel (kMma: some; the
                CUDA-core one: none).
  7. kernel   - K2 against its plain version at the train path's shapes
                (2048 rays of a synthetic view, 64 samples, hidden 128,
                L=10, deterministic depths), f32 (the CUDA cores) and bf16
                (the tensor cores, the launch counted; each trunk leaf's
                scale too); two launches with one seed are bit-identical,
                another seed differs.
  8. jitter   - K2's own depth draws (the probe entry point): every z in
                its bin, uniform in the bin (mean, variance, deciles),
                adjacent ray tiles uncorrelated, seed replay, and no
                dependence on the tile size.
 9. train    - `tinynerf_tpu_torch.train` in process, 1000 steps of 2048
                rays at full width, bf16, tail holdout 4: fused (K2 must
                launch 1000 times, K1 must render, every launch of both on
                the tensor cores) and eager; each run's train PSNR must
                rise >= 3 dB and the held-out PSNRs agree within 1.5 dB;
                then the fused run resumes to 1200 steps (its K1 and K2
                launches on the tensor cores too).
 10. timing   - one 2048-ray K2 call against its plain version (f32 on the
                CUDA cores, bf16 on the tensor cores), and steps/s and
                rays/s of the train loop, fused against eager; as a
                reading, K2's per-call weight packing alone.
 11. build    - the full-NeRF kernels fused_nerf.cu (K3 and K5, one
                library; its nvcc runs beside the other four), with
                ptxas's register and spill counts and the HMMA
                instructions of each kernel (cuobjdump -sass): the bf16
                tensor-core kernel (kMma) has them, the CUDA-core one none.
 12. kernel   - K3 against its plain version at the flagship width
                (hidden 256, depth 8, skip 4, L=10, L_dir=4, rgb_hidden
                64) on 4096 rays of a synthetic pose, f32 (the CUDA cores)
                and bf16 (the tensor cores, every launch counted):
                (a) analytic depths, S=64, weights out; (b) the depth
                union S=192 of the plain coarse pass plus 128 fine samples.
                As a reading, bf16 K3's weights against bf16 K4's on the
                same rays and linspace depths (same per-point code).
 13. kernel   - K5 against its plain version at hidden 128 on a 512-sample
                union (the --n-fine 448 recipe), block 64, f32 and bf16
                (launches counted as K3's); K5 against K3 on the flagship's
                S=192 union, f32 and bf16.
 14. serving  - flagship NeRF checkpoint: `tinynerf_tpu_torch.eval` on 2
                views (K3 twice per chunk; the image against --no-fused)
                and an 8-frame `make_gif`; then `eval --n-fine 448` on a
                hidden-128 checkpoint (the fine pass through K5); every
                K3 and K5 launch of the three (bf16) on the tensor cores.
 15. timing   - one 4096-ray flagship hierarchical chunk fused against
                eager and each K3 launch against its plain version; one
                4096-ray K5 call at S=512 against its plain version; one
                100x100 flagship image fused against eager (bf16); the
                same K3 and K5 calls in f32 (the CUDA cores); as a reading,
                the per-call weight packing alone.
 16. build    - the NeRF train kernels fused_nerf_train.cu (K4 and K6, one
                library; its nvcc runs beside the other three), with
                ptxas's registers and spills, and the HMMA instructions of
                each kernel (cuobjdump -sass): the bf16 walk that K4 and K6
                share has them, the CUDA-core walk none.
 17. kernel   - K4 against its plain version on 2048 rays of a synthetic
                view, f32 (against float64 sums; the CUDA cores) and bf16
                (the tensor cores, every launch counted; also each
                tensor-core leaf's scale): (a) the flagship coarse pass,
                S=64, weights and z out, with and without sigma-noise, and
                the f32 plain version on the CPU against the same float64
                sums; (b) a hidden-128 fine pass on a 128-sample union; (c)
                the hidden-128 coarse pass jittered in the kernel, on the
                depths it emitted; seed replay.
 18. jitter   - K4's emitted depths: in their bins, uniform, adjacent
                ray tiles uncorrelated, seed replay.
 19. kernel   - K6 against its plain version (flagship fine S=192 and
                hidden 128 S=512, block 64; bf16 on the tensor cores, f32
                on the CUDA cores), f32 K6 against K4 on one union, and the
                flagship fused step against autograd of the eager
                hierarchical loss (its K4 and K6 launches on the tensor
                cores); bf16 K6's tensor-core leaves and the step's also by
                their scale.
 20. train    - `tinynerf_tpu_torch.train --model nerf` in process at
                hidden 128, 500 steps fused (K4 twice a step, every launch
                on the tensor cores) and eager; the flagship 20 steps (K4
                and K6 once a step each, all on the tensor cores), its
                resume to 25, and `eval` of its checkpoint (K3).
 21. timing   - one flagship K4 coarse call (its seed on the device, as the
                train step passes it), one K6 fine call and one flagship
                train step against their plain versions; as readings, K4 on
                the K6 call's fine union (both on the tensor cores) and K4
                with an int seed (a blocking host-to-device copy a call).
 22. build    - the block-partials kernel pair fused_partials.cu (K7
                forward and backward, one library; its nvcc runs beside the
                other four), with ptxas's registers and spills and the HMMA
                instructions of each kernel: the bf16 forward and backward
                walks have them, the CUDA-core walks none.
 23. kernel   - K7 against its plain versions at the flagship width on 2048
                rays, both shards of the coarse pass (2 x 32, weights out) and
                of the fine union (2 x 96, block 48, sigma-noise) at world 2,
                f32 (gradients against float64 sums; the CUDA cores) and bf16
                (the tensor cores, every launch counted), with random
                cotangents (g_T and g_w included); the gates on one-signed
                cotangents, the signed ones a reading (bf16: each tensor-core
                leaf's scale too); two shards combined against K3's composite
                of the union and their MSE gradient against K6's; same inputs
                twice bit-identical.
 24. train    - (a) one flagship step of the world-1 sharded block, K7
                against the eager shard (2 K7 forwards and backwards, all on
                the tensor cores; the tensor-core leaves' scale too);
                (b) `torch.distributed.run --nproc-per-node 2 -m
                tinynerf_tpu_torch.train --data-parallel --sample-parallel 2`
                at the flagship, two ranks sharing the card (gloo), 20 steps
                (every K7 launch on the tensor cores), then a resume to 25,
                then `--data-parallel` alone (K4/K6 per rank, on the tensor
                cores), 10 steps: every rank exits 0 with bit-identical
                parameters; (c) one sharded pass on the same depths, world 2
                (spawned ranks) against world 1.
 25. timing   - the K7 forward and backward at the fine and coarse shards, and
                the world-1 sharded step, against their plain versions; the
                steps/s of the 2-rank runs (two processes on one card, not
                scaling).
 26. route    - bf16 K4 (S=64), K6 (S=192, block 64) and the K7 pair (a
                96-sample shard, block 48) at widths off the tensor cores'
                layout (hidden 48 with rgb_hidden 24; hidden 256 with
                rgb_hidden 32) against their plain versions on 2048 rays:
                the bf16 gates (loss rel < 1e-3, worst leaf cosine > 0.98,
                the trunk and rgb_in leaves' scale; the partials under the
                render gates), one launch each and none on the tensor cores,
                no HMMA in the CUDA-core walks they run; then `train --model
                nerf --hidden 48 --rgb-hidden 24 --n-fine 64`, bf16 fused, 50
                steps (K4 twice a step, off the tensor cores).
 27. levers   - (a) the flagship with every lever on (pool, precrop 50, noise
                decay 100 to 0.1, lr decay 200 to 5e-5, AdamW 1e-4, EMA 0.99,
                the sparsity prior, strided holdout 4, eval every 100,
                ckpt-keep 2), 200 steps and a resume to 250: every K4 and K6
                launch on the tensor cores, the lr at the schedule's value
                across the resume, the EMA twin served by `eval --ema
                --holdout-views` on the strided poses, two rotated copies,
                held-out JSONL records with eval_ema; (b) the TinyNeRF through
                K2 with pool, precrop, noise decay and the EMA, 1000 steps,
                train PSNR up >= 3 dB; (c) a background-pinned run (margin
                100 dB) exits 3 in a subprocess, with its checkpoint and its
                sigma_death record; (d) timing: one flagship step with every
                lever on against the plain recipe's, the prior and the EMA
                update alone.
 28. sharded  - `torch.distributed.run --nproc-per-node 2 ... --data-parallel
                --sample-parallel 2` at the flagship with the prior, the EMA
                and the lr schedule, 10 steps: every rank exits 0 with
                bit-identical parameters and EMA, every K7 launch on the
                tensor cores.
 29. f3       - K3 (S=64, weights out), K5 (S=192, block 64), K4 (S=64), K6
                (S=192, block 64) and the K7 pair (a 96-sample shard, block
                48) at widths the CUDA-core kernels once refused (hidden 48
                with rgb_hidden 64; hidden 36 with rgb_hidden 20, zero-padded
                to 40 and 24), f32 and bf16, against their plain versions on
                2048 rays: the render gates and the NeRF pass gates, one
                launch each and none on the tensor cores; their bf16 times at
                hidden 48; then `train --model nerf --hidden 48` with the
                default rgb_hidden 64, fused, 50 steps (K4 twice a step).
 30. ndc      - the forward-facing scene (synthetic.py, 106 poses of
                100x100): `train --ndc` (TinyNeRF) fused (K2 and K1, on the
                tensor cores) and eager, 1000 steps each, train PSNR up >= 3
                dB, held-out within 1.5 dB; the flagship `--ndc` 20 steps and
                a resume to 25 (K4 and K6 on the tensor cores), its K3 image
                from the checkpoint against the eager one under the bf16
                render gates.
 31. aux      - `eval --save-depth` and `make_gif --depth` on the flagship
                (phase 27's lever checkpoint) and the NDC checkpoints: depth
                and acc maps written, the depth finite and inside [near, far]
                where acc > 0.5 and, on the trained checkpoints, not constant.
 32. slice    - the flagship `--proposal occupancy` (one MLP, 64 + 128 grid-
                proposed samples a ray through K6, a 64^3 grid over the
                capture's box rebuilt once per block, served through K5): 200
                steps fused and a resume to 250 (every K6 and K5 launch on the
                tensor cores), 200 steps eager, held-out within 1.5 dB; a
                100x100 K5 image against the eager one under the render gates;
                the occupancy step, the grid rebuild and the image timed
                against the hierarchical flagship's.
 33. dp       - `torch.distributed.run --nproc-per-node 2 ... --data-parallel
                --proposal occupancy`, 10 steps, the ranks sharing the card:
                bit-identical parameters, K6 on the tensor cores; `--ndc
                --data-parallel --sample-parallel 2`, 5 steps (K7 on the
                tensor cores); then a short `--proposal occupancy --ndc` run
                (the NDC cube as the box).
 34. grid     - the grid family (models/grid_nerf.py: the encoding on
                kernel G, kernels/grid_encode.py; the rest eager torch) at
                the JAX package's default width (8 levels 16-128, 4 dense,
                tables of 2^17, hidden 64; 1,273,971 parameters), bf16, the
                README recipe (pool, lr 0.01, noise decay 1000): 1000 steps
                (G's forward at least once a step, its backward exactly
                once), train PSNR up >= 3 dB (the JAX package's 25.30
                dB at step 1000 printed beside it), a resume to 1200
                bit-identical to an uninterrupted 1200, `eval
                --holdout-views --save-depth` and `make_gif --depth`; 2-rank
                `--data-parallel` (bit-identical), `--ndc` 20 steps (the NDC
                cube as the box), the regularized levers with the prior 50
                steps; none of K1-K7 launched; the step and a 100x100 image
                timed.
 35. scenes   - `python -m tinynerf_tpu_torch.synthetic --scene lattice` on
                the card, timed, three of its poses rendered again on the
                CPU within 1e-4, its white share; seeds 1 and 2 distinct and
                finite; the lattice's flagship precrop probe (hidden 256, 64
                + 128 samples, pool, precrop 500, noise decay 2000), 2000
                steps: K4 and K6 once a step on the tensor cores, no
                sigma_death record, train PSNR >= 14.5 dB, held-out through
                K3 printed beside the JAX package's 31.05 dB; as a reading,
                the same probe without precrop under a tightened watchdog.
 36. multiscene - multi-scene training (multiscene.py, train_multiscene.py):
                (a) the scene-axis kernels' HMMA per route; batched K2 (8
                TinyNeRFs x 1024 rays x 64, hidden 128, f32 and bf16), K4 at hidden 128 (coarse S=64 jittered, fine on the
                128-sample union) and the flagship K4 + K6 (union 192, block
                64), K = 8: one launch a pass, each scene bit-identical to its
                one-scene launches, K4's depths to jitter_probe(seed k), the
                plain versions' gates per scene; (b) `train_multiscene` with
                its defaults (8 scenes, 400x400, 16 poses, 2000 steps) fused:
                K2 once a step for all scenes on the tensor cores, every
                scene's train PSNR up >= 3 dB, four K1 previews, the batched
                checkpoint; 200 eager steps; (c) --model nerf 200 steps (K4
                twice a step, batched, mean rise >= 2 dB, K3 previews); (d)
                --hidden 256 --n-fine 128, 20 steps (K4 + K6 once a step);
                (e) 2 ranks sharing the card, 50 steps: every scene's
                parameters and Adam state bit-identical to world 1; (f) the
                batched calls against 8 one-scene launches and the plain
                versions, with their bounds, the flagship launch's buffers,
                the 8-scene loop fused against eager, the per-step host work.
 37. tiny domain - K1 and K2 at every TinyNeRF shape the JAX kernels take:
                (a) K2 at S=20 (tiles of 3 rays: the batch padded), hidden
                36 (padded to 40), 168 and 256, depth 6, S=96 and 128, the
                8 x 256 trunk with its skip at 4 and hidden 264 at S=192,
                f32 and bf16, 2048 rays, each one launch on the route its
                rules give (the F4c shapes on the spill route) under the K2
                gates; the spill kernels' HMMA per route; (b) the spill route
                forced at the recipe's shape (and at hidden 36) bit-identical
                to the shared route; (c) K1 at hidden 36 and 264, S=192 at
                hidden 256 and 264, S=512 (the general kernel: rounds and
                segments) and the full width, f32 and bf16, under the render
                gates; (d) the scene axis at widths off 8: K2 x3 at hidden
                36 (S=20) and at the full width (spill), K4 and K6 x3 at
                hidden 36 / rgb_hidden 20, each scene bit-identical to its
                one-scene launch; (e) the slice, `train --hidden 256 --depth
                8 --skip-at 4`, 500 steps fused (K2 every step on the spill
                route and the tensor cores, K1 on the tensor cores) and
                eager: rise >= 3 dB, held-out within 1.5 dB; (f) `train
                --hidden 36 --n-samples 20` (200 steps), `--hidden 264
                --n-samples 192` (20 steps: K2 spill on the CUDA cores, K1
                in segments), `train_multiscene --hidden 36` (20 steps, the
                batched K2); (g) timing: K2 shared against spill at the
                recipe's shape, the full width, hidden 264 at S=192; K1 at
                the full width and at hidden 264, S=192; the full-width
                spill launch's buffers.
 38. nerf domain - K3-K7 at every NeRF width and sample count the JAX
                kernels take (F6: hidden 320, 512 / rgb_hidden 128 past 512
                threads or 227 KB; F7: S=100, unions 164 and 228 whose tiles
                end in partial 128-point chunks): (a) K4, K6 (or K4 on the
                union), K3 and K5 at hidden 320, 512/128, S=100 and the
                flagship's union 228 in blocks of 57, and the K7 pair at
                hidden 320, bf16, 2048 rays with the recipes' density noise,
                each one launch on the route nerf_shape configures (the
                general kernel; X in device memory at 512) under the bf16
                pass and render gates; (b) `train --model nerf` at hidden
                320 (and its `eval`: K3), 320 with --n-fine 128 (K5),
                --hidden 384 --rgb-hidden 96, --hidden 512 --rgb-hidden 128,
                --rgb-hidden 320, --n-samples 65, --n-samples 100 and
                --hidden 256 --n-samples 100 --n-fine 128, 60 steps each fused and
                eager (every K4 and K6 launch on its route; held-out within
                1.5 dB), and sample-parallel 2 at hidden 320 on two ranks
                (the K7 pair on the general walk), fused and eager side by
                side, 3 steps; (c)
                timing: each kernel at its new shape against its plain
                version, with its bound.
 39. grid kernel - G, the hash-grid encoding (csrc/grid_encode.cu,
                kernels/grid_encode.py; it replaces no TPU kernel: the JAX
                package runs the encoding in XLA) on 4096 rays x 64
                stratified samples of a hemisphere pose: at Instant-NGP's
                published sizes (16 levels 16-2048, F = 2, T = 2^19) and at
                the JAX defaults, both wrappers against the plain versions
                (encode_levels_plain, encode_levels_bwd_plain) bit for bit,
                two backward passes identical, 1 forward and 5 backward
                launches; each pass timed against its plain version and its
                bound (bytes: the points, the tables and the features once),
                and, as a reading, each stage's device time. Alone:
                python3 -c "import chip_smoke as s; s.run_grid_kernel()".

Weights are random from a seed throughout. The line before the kernels
line gives the seconds of all phases.

Exits non-zero without printing a result when there is no CUDA device,
when the package is missing, or when any phase fails. The line before
the last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Artifacts go to outputs/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

OUT_DIR = os.path.join("outputs", "chip_smoke")
N_RAYS = 8192
N_SAMPLES = 64
N_RAYS_TRAIN = 2048  # rays per train step (the reference recipe)
TRAIN_ITERS = 1000
TIMED_STEPS = 50
# Per-ray max-channel error gates. bf16: the JAX package's own render
# parity gates (bench.py:707-718); the tail gate counts rays whose last
# sample's density sits at the ReLU boundary, where the 1e10 terminal
# delta flips alpha between 0 and 1.
GATES = {
    torch.float32: {"p999": 5e-4, "mean": None, "flip": 2.5e-3},
    torch.bfloat16: {"p999": 3e-2, "mean": 1e-3, "flip": 2.5e-3},
}
FLIP_ERR = 3e-2


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the rate for the kernels' bf16 inputs and the device memory's rate.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores (the CUDA-core walks)


def macs_per_point(module: torch.nn.Module) -> int:
    """Multiply-adds of one point through every nn.Linear of `module`."""
    return sum(m.in_features * m.out_features for m in module.modules()
               if isinstance(m, torch.nn.Linear))


def train_macs_per_point(module: torch.nn.Module) -> int:
    """Multiply-adds of one point's training pass: the forward and the
    weight-gradient products in full, and the upstream (input-gradient)
    products only where a layer's input comes from another layer: none
    for the first layer (the encoding), and the first `hidden` rows of a
    wider input (the skip layer's [h, enc], rgb_in's [h, dir_enc])."""
    lin = [m for m in module.modules() if isinstance(m, torch.nn.Linear)]
    hidden = lin[0].out_features
    upstream = sum(min(m.in_features, hidden) * m.out_features for m in lin[1:])
    return 2 * macs_per_point(module) + upstream


def kernel_entry(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
                 ms: float, plain_ms: float, flops: float, nbytes: float) -> dict:
    """One kernel's record for the {"kernels": [...]} line. bound_ms is the
    least time the card could take for the work timed in `ms`: the larger
    of its operations over the bf16 peak and of its bytes (each input read
    once, each output written once) over the memory rate. No single
    PyTorch call computes a fused MLP pass (+ composite, + backward), so
    library_ms is null."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def ray_errors(a: torch.Tensor, b: torch.Tensor, width: int = 3) -> dict:
    """Stats of the per-ray max error over the last `width` values (3 for
    rgb; S for an (R, S) weights array)."""
    e = (a.float() - b.float()).abs().reshape(-1, width).max(dim=1).values
    return {
        "max": e.max().item(),
        "p999": torch.quantile(e, 0.999).item(),
        "mean": e.mean().item(),
        "flip": (e > FLIP_ERR).float().mean().item(),
    }


def within(err: dict, dtype: torch.dtype) -> bool:
    g = GATES[dtype]
    return (
        err["p999"] < g["p999"]
        and (g["mean"] is None or err["mean"] < g["mean"])
        and err["flip"] < g["flip"]
    )


def card_line() -> str:
    """The card's name and power limit, exactly as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts(lib, opcode: str) -> dict:
    """Instructions of `opcode` per kernel function of a built library, from
    cuobjdump -sass (next to nvcc)."""
    from tinynerf_tpu_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and f" {opcode}." in line:
            counts[fn] += 1
    return counts


def check_hmma(lib, kernel: str, what: str) -> None:
    """Print the HMMA instructions per kernel of a built library and check
    that the tensor-core instantiation of `kernel` (kMma = true) holds some
    and the CUDA-core one (kMma = false) none."""
    hmma = sass_counts(lib, "HMMA")
    print(f"[build] HMMA instructions per kernel (cuobjdump -sass): {json.dumps(hmma)}", flush=True)
    check(any(f"{kernel}ILb1E" in fn and n > 0 for fn, n in hmma.items())
          and not any(f"{kernel}ILb0E" in fn and n for fn, n in hmma.items()),
          f"the bf16 {what} kernel (kMma=true) holds HMMA instructions; the CUDA-core one none")


def walk_hmma(hmma: dict) -> list:
    """The training walk's kernels among sass_counts' -> (kMma, kGeneral,
    HMMA count) each: nerf_walk(_scenes)_kernel<Walk, kMma, kGeneral>."""
    import re

    out = []
    for fn, n in hmma.items():
        m = re.search(r"nerf_walk(?:_scenes)?_kernelILNS_4WalkE\dELb([01])ELb([01])E", fn)
        if m:
            out.append((m.group(1) == "1", m.group(2) == "1", n))
    return out


def timed_build(name: str):
    from tinynerf_tpu_torch.kernels import _build

    t0 = time.time()
    lib = _build.build(name)
    return lib, time.time() - t0


def run(build_render) -> dict:
    from tinynerf_tpu_torch import main as main_mod
    from tinynerf_tpu_torch import make_gif as gif_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_render import (
        fused_render_rays, fused_render_rays_plain, pack_tiny_weights,
    )
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF
    from tinynerf_tpu_torch.ops.camera import spiral_poses
    from tinynerf_tpu_torch.ops.rays import get_rays
    from tinynerf_tpu_torch.render import chunked_over_rays, make_image_renderer
    from tinynerf_tpu_torch.synthetic import FOCAL, H, W, hemisphere_poses
    from tinynerf_tpu_torch.utils.checkpoint import save_params

    # Plain versions are the reference: keep their matmuls in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)
    card = card_line()
    print(card, flush=True)  # name, power limit: exactly as nvidia-smi prints them

    # 1. build
    lib, secs = build_render.result()
    print(f"[build] fused_render.cu -> {lib.name} in {secs:.2f}s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)
    check_hmma(lib, "fused_render_kernel", "K1")

    # 2. kernel against its plain version, at the main path's shapes
    t0 = time.time()
    pose = torch.from_numpy(hemisphere_poses()[0]).to(dev)
    rays_o, rays_d = get_rays(H, W, FOCAL, pose)
    rays_o, rays_d = rays_o[:N_RAYS].contiguous(), rays_d[:N_RAYS].contiguous()
    kw = dict(n_samples=N_SAMPLES, near=2.0, far=6.0, num_freqs=10)
    errs, models = {}, {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            cfg = Config(bf16=dtype == torch.bfloat16).model_cfg()
            models[dtype] = model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(0),
                                             device=dev)
            mma0 = fused_render_rays.mma_launches
            got = fused_render_rays(model, rays_o, rays_d, **kw)
            torch.cuda.synchronize()
            mma = fused_render_rays.mma_launches - mma0
            want = fused_render_rays_plain(model, rays_o, rays_d, **kw)
            check(got.shape == (N_RAYS, 3) and bool(torch.isfinite(got).all()), "kernel output finite")
            errs[dtype] = err = ray_errors(got, want)
            route = "tensor cores" if mma else "CUDA cores"
            print(f"[kernel] fused_render {str(dtype)[6:]} ({route}): {json.dumps(err)}", flush=True)
            check(within(err, dtype), f"fused_render {dtype} within {GATES[dtype]}")
            check(mma == int(dtype == torch.bfloat16),
                  f"fused_render {dtype}: bf16 on the tensor cores, f32 on the CUDA cores")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 3. the main path: python -m tinynerf_tpu_torch.main, in process
    t0 = time.time()
    cfg = Config(data_path=os.path.join(OUT_DIR, "absent.npz"), out_dir=OUT_DIR, chunk=8192)
    fused_render_rays.launches = fused_render_rays.mma_launches = 0
    img = main_mod.main(cfg)
    launches, mma_launches = fused_render_rays.launches, fused_render_rays.mma_launches
    d = ensure_data(cfg.data_path, device=dev)  # the scene main rendered
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    hw = d["images"].shape[1:3]
    check(d["synthetic"] and img.shape == (*hw, 3), f"main image shape {img.shape}")
    check(bool((img >= 0).all() and (img <= 1).all()), "main image finite, in [0, 1]")
    check(launches > 0, "main launched fused_render")
    check(mma_launches == launches, "every bf16 K1 launch of main on the tensor cores")
    model = TinyNeRF(cfg.model_cfg(), generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    eager = make_image_renderer(H=hw[0], W=hw[1], focal=focal, chunk=8192, model_cfg=cfg.model_cfg())
    err = ray_errors(torch.from_numpy(img), eager(model, poses[0]).cpu())
    print(f"[main] {hw[0]}x{hw[1]} image, launches={launches} (tensor cores {mma_launches}), vs "
          f"eager render: {json.dumps(err)}", flush=True)
    check(within(err, torch.bfloat16), "main image agrees with the eager render")
    print(f"[main] ok in {time.time() - t0:.2f}s", flush=True)

    # 4. serving from a checkpoint: make_gif, 60 frames
    t0 = time.time()
    ckpt = os.path.join(OUT_DIR, "untrained.npz")
    save_params(ckpt, model, step=0, meta={"model": "tinynerf", "cfg": {
        "hidden": cfg.hidden, "depth": cfg.depth, "skip_at": cfg.skip_at,
        "num_freqs": cfg.num_freqs}})
    gif_cfg = gif_mod.GifConfig(ckpt_path=ckpt, data_path=cfg.data_path,
                                out_path=os.path.join(OUT_DIR, "novel_views.gif"))
    fused_render_rays.launches = fused_render_rays.mma_launches = 0
    frames = gif_mod.main(gif_cfg)
    gif_launches = fused_render_rays.launches
    check(fused_render_rays.mma_launches == gif_launches,
          "every bf16 K1 launch of make_gif on the tensor cores")
    check(frames.shape == (60, *hw, 3) and frames.dtype.name == "uint8", f"gif frames {frames.shape}")
    check(gif_launches > 0, "make_gif launched fused_render")
    launches += gif_launches
    first = spiral_poses(poses[0], n_frames=60, radius=0.3)[0]
    want = (torch.clamp(eager(model, first), 0, 1) * 255).to(torch.uint8).cpu()
    diff = (torch.from_numpy(frames[0]).int() - want.int()).abs().reshape(-1, 3).max(dim=1).values
    frac = (diff > round(FLIP_ERR * 255)).float().mean().item()
    print(f"[make_gif] launches={gif_launches} frame 0 vs eager: max {diff.max().item()} "
          f"levels, fraction > {round(FLIP_ERR * 255)} levels {frac}", flush=True)
    check(frac < GATES[torch.bfloat16]["flip"], "gif frame agrees with the eager render")
    print(f"[make_gif] ok in {time.time() - t0:.2f}s", flush=True)

    # 5. timing: plain, kernel, kernel, plain; bf16 (main's model, the
    #    tensor cores) and f32 (phase 2's, the CUDA cores)
    t0 = time.time()
    with torch.no_grad():
        cases = {}
        for tag, m in (("bf16", model), ("f32", models[torch.float32])):
            cases[tag, "batch"] = {
                "kernel": lambda m=m: fused_render_rays(m, rays_o, rays_d, **kw),
                "plain": lambda m=m: fused_render_rays_plain(m, rays_o, rays_d, **kw),
            }
            cases[tag, "image"] = {
                name: (lambda f=f, m=m: chunked_over_rays(lambda ro, rd: f(m, ro, rd, **kw),
                                                          *hw, focal, poses[0], 8192))
                for name, f in (("kernel", fused_render_rays), ("plain", fused_render_rays_plain))
            }
        times = {}
        for key, fns in cases.items():
            for name in ("plain", "kernel", "kernel", "plain"):
                times.setdefault((*key, name), []).append(cuda_ms(fns[name]))
        # A reading: what each bf16 call spends packing its weights (one
        # concatenation and one gather each for w_fwd and the fragments).
        pack_ms = [cuda_ms(lambda: pack_tiny_weights(model, model.cfg, mma=True))
                   for _ in range(2)]
    ms = {k: min(v) for k, v in times.items()}
    for tag, route in (("bf16", "tensor cores"), ("f32", "CUDA cores")):
        print(f"[timing] {card}: {tag} ({route}): {N_RAYS}-ray batch kernel "
              f"{ms[tag, 'batch', 'kernel']:.4f} ms, plain {ms[tag, 'batch', 'plain']:.4f} ms; "
              f"{hw[0]}x{hw[1]} image kernel {ms[tag, 'image', 'kernel']:.4f} ms, plain "
              f"{ms[tag, 'image', 'plain']:.4f} ms", flush=True)
    print(f"[timing] {card}: K1's weight packing of one bf16 call (reading): {min(pack_ms):.4f} ms "
          f"(runs {pack_ms}); all runs "
          f"{json.dumps({' '.join(k): v for k, v in times.items()})}", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    n_par = sum(p.numel() for p in model.parameters())
    return kernel_entry(
        "fused_render_rays", "tinynerf_tpu_torch/csrc/fused_render.cu",
        "tinynerf_tpu/kernels/fused_render.py:211", launches, errs[torch.bfloat16]["max"],
        ms["bf16", "batch", "kernel"], ms["bf16", "batch", "plain"],
        flops=2 * N_RAYS * N_SAMPLES * macs_per_point(model),
        nbytes=4 * (N_RAYS * (3 + 3 + 3) + n_par))


# The tensor-core products of every bf16 K4, K6 and K7 launch write the
# gradients of the trunk's and rgb_in's weights and biases. The cosine gate
# reads a leaf's direction but not its length, so each of those leaves is
# also held to its scale along the reference: |<g, ref> / <ref, ref> - 1|
# < MMA_SCALE. A bias row counted twice, a k-step of points dropped or a
# stale partial row added moves it (k6_variants.py builds each; PERF.md
# has the readings).
MMA_SCALE = 0.01
TENSOR_CORE_LEAVES = ("layers.", "rgb_in.")


def mma_scale_error(names, got, want) -> float:
    """Largest |<g, w> / <w, w> - 1| over the leaves named in
    TENSOR_CORE_LEAVES."""
    return max(abs(float((g * w).sum() / (w * w).sum().clamp_min(1e-30)) - 1)
               for n, g, w in zip(names, got, want) if any(k in n for k in TENSOR_CORE_LEAVES))


def leaf_errors(got, want) -> dict:
    """Worst per-leaf errors of a gradient list against its reference."""
    return {
        "max_abs": max(float((g - w).abs().max()) for g, w in zip(got, want)),
        "max_rel_to_leaf": max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                               for g, w in zip(got, want)),
        "max_rel_norm": max(float((g - w).norm() / w.norm().clamp_min(1e-30))
                            for g, w in zip(got, want)),
        "min_cosine": min(float((g * w).sum() / (g.norm() * w.norm()).clamp_min(1e-30))
                          for g, w in zip(got, want)),
    }


def logged_psnrs(path: str) -> list:
    with open(path) as f:
        return [r["psnr"] for r in map(json.loads, f) if "psnr" in r]


def run_train(build_train) -> dict:
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays
    from tinynerf_tpu_torch.kernels.fused_render import pack_tiny_weights
    from tinynerf_tpu_torch.kernels.fused_train import (
        depth_grid, fused_loss_grads, fused_loss_grads_plain, jitter_probe, make_fused_grad_fn,
    )
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF
    from tinynerf_tpu_torch.ops.rays import get_rays, get_rays_for_poses
    from tinynerf_tpu_torch.training import init_train_state, make_train_block

    dev = torch.device("cuda", 0)
    card = card_line()

    # 6. build
    lib, secs = build_train.result()
    print(f"[build] fused_train.cu -> {lib.name} in {secs:.2f}s (nvcc beside fused_render.cu)",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)
    check_hmma(lib, "fused_train_kernel", "K2")

    # 7. K2 against its plain version at the train path's shapes
    t0 = time.time()
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    rays_o, rays_d = get_rays(H, W, focal, poses[0])
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:N_RAYS_TRAIN].to(dev)
    ro, rd = rays_o[idx].contiguous(), rays_d[idx].contiguous()
    tgt = images[0].reshape(-1, 3)[idx].contiguous()
    kw = dict(n_samples=N_SAMPLES, near=2.0, far=6.0, num_freqs=10)
    errs, models = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = Config(bf16=dtype == torch.bfloat16).model_cfg()
        models[dtype] = model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        mma0 = fused_loss_grads.mma_launches
        loss, grads = fused_loss_grads(model, ro, rd, tgt, 0, randomized=False, **kw)
        torch.cuda.synchronize()
        mma = fused_loss_grads.mma_launches - mma0
        want_loss, want = fused_loss_grads_plain(model, ro, rd, tgt, 0, randomized=False, **kw)
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads),
              "K2 loss and gradients finite")
        rel = abs(float(loss) - float(want_loss)) / float(want_loss)
        names = [n for n, _ in model.named_parameters()]
        errs[dtype] = err = {"loss": float(loss), "loss_rel": rel, **leaf_errors(grads, want),
                             "mma_scale_err": mma_scale_error(names, grads, want)}
        route = "tensor cores" if mma else "CUDA cores"
        print(f"[kernel] fused_train {str(dtype)[6:]} ({route}): {json.dumps(err)}", flush=True)
        check(mma == int(dtype == torch.bfloat16),
              f"fused_train {dtype}: bf16 on the tensor cores, f32 on the CUDA cores")
        if dtype == torch.float32:
            check(rel < 1e-5 and err["max_rel_to_leaf"] <= 2e-4,
                  "fused_train f32: loss rel < 1e-5, per-leaf |err| <= 2e-4 max|leaf|")
        else:
            check(rel < 1e-3 and err["min_cosine"] > 0.98 and err["mma_scale_err"] < MMA_SCALE,
                  f"fused_train bf16: loss rel < 1e-3, per-leaf cosine > 0.98, each trunk leaf's "
                  f"scale within {MMA_SCALE} of 1")
    model = models[torch.bfloat16]
    runs = []
    for seed in (11, 11, 12):
        loss, grads = fused_loss_grads(model, ro, rd, tgt, seed, randomized=True, **kw)
        runs.append((float(loss), [g.clone() for g in grads]))
    same = runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    differ = runs[0][0] != runs[2][0] and not torch.equal(runs[0][1][0], runs[2][1][0])
    print(f"[kernel] fused_train jittered: seed 11 twice bit-identical {same}, "
          f"seed 12 differs {differ} (losses {runs[0][0]}, {runs[1][0]}, {runs[2][0]})", flush=True)
    check(same and differ, "K2 deterministic per seed, different across seeds")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 8. jitter statistics of K2's own depth draws
    t0 = time.time()
    R, S = 16384, N_SAMPLES
    z = jitter_probe(123, R, S, 2.0, 6.0, tile=1, device=dev)
    h = 4.0 / (S - 1)
    grid = depth_grid(S, 2.0, 6.0, dev)
    s = torch.arange(S, device=dev)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == S - 1, grid, grid + 0.5 * h)
    u = ((z - lower) / (upper - lower)).double()
    n = u.numel()
    deciles = (torch.histc(u.float(), bins=10, min=0.0, max=1.0) / n).tolist()
    corr = float(torch.corrcoef(torch.stack([u[:-1].reshape(-1), u[1:].reshape(-1)]))[0, 1])
    stats = {
        "in_bin": bool(((z >= lower) & (z <= upper)).all()),
        "mean": float(u.mean()), "var": float(u.var()), "deciles": deciles,
        "adjacent_tile_corr": corr,
        "replay": bool(torch.equal(z, jitter_probe(123, R, S, 2.0, 6.0, tile=1, device=dev))),
        "new_seed_changed": float((z != jitter_probe(124, R, S, 2.0, 6.0, tile=1, device=dev))
                                  .float().mean()),
        "tile_independent": bool(torch.equal(z, jitter_probe(123, R, S, 2.0, 6.0, tile=16,
                                                             device=dev))),
    }
    print(f"[jitter] {R}x{S} draws: {json.dumps(stats)}", flush=True)
    # Gates at 6 standard errors of each statistic for n uniform draws.
    check(stats["in_bin"], "every z in its bin")
    check(abs(stats["mean"] - 0.5) < 6 / (12 * n) ** 0.5, "mean of u")
    check(abs(stats["var"] - 1 / 12) < 6 * (1 / 180 / n) ** 0.5, "variance of u")
    check(max(abs(q - 0.1) for q in deciles) < 6 * (0.09 / n) ** 0.5, "deciles of u")
    check(abs(corr) < 6 / n ** 0.5, "adjacent ray tiles uncorrelated")
    check(stats["replay"] and stats["new_seed_changed"] > 0.99 and stats["tile_independent"],
          "seed replay, new seed, tile independence")
    print(f"[jitter] ok in {time.time() - t0:.2f}s", flush=True)

    # 9. the train path: python -m tinynerf_tpu_torch.train, in process
    t0 = time.time()
    runs = {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        cfg = Config(data_path=data_path, out_dir=os.path.join(OUT_DIR, f"train_{name}"),
                     iters=TRAIN_ITERS, holdout=4, resume=False,
                     ckpt_path=os.path.join(OUT_DIR, f"train_{name}.npz"),
                     metrics_path=os.path.join(OUT_DIR, f"train_{name}.jsonl"),
                     fused_train=fused)
        if os.path.exists(cfg.metrics_path):
            os.unlink(cfg.metrics_path)
        fused_loss_grads.launches = fused_loss_grads.mma_launches = 0
        fused_render_rays.launches = fused_render_rays.mma_launches = 0
        res = train_mod.main(cfg)
        k2, k1 = fused_loss_grads.launches, fused_render_rays.launches
        check(fused_loss_grads.mma_launches == k2 and fused_render_rays.mma_launches == k1,
              f"{name} run: every bf16 K1 and K2 launch on the tensor cores")
        psnrs = logged_psnrs(cfg.metrics_path)
        rise = sum(psnrs[-5:]) / 5 - psnrs[0]
        runs[name] = {"cfg": cfg, "k2": k2, "k1": k1, "rise": rise,
                      "heldout": res["eval"]["psnr_mean"], "rays_per_sec": res["rays_per_sec"]}
        print(f"[train] {name}: K2 launches {k2}, K1 launches {k1}, train PSNR "
              f"{psnrs[0]:.2f} -> {sum(psnrs[-5:]) / 5:.2f} dB (rise {rise:.2f}), held-out "
              f"{res['eval']['psnr_mean']:.2f} dB, {res['rays_per_sec']:,.0f} rays/s", flush=True)
        check(rise >= 3.0, f"{name} train PSNR rises >= 3 dB")
    check(runs["fused"]["k2"] == TRAIN_ITERS, "fused run launched K2 once per step")
    check(runs["fused"]["k1"] > 0, "fused run rendered through K1")
    check(runs["eager"]["k2"] == 0, "eager run did not launch K2")
    gap = abs(runs["fused"]["heldout"] - runs["eager"]["heldout"])
    print(f"[train] held-out PSNR fused vs eager: {gap:.3f} dB apart", flush=True)
    check(gap <= 1.5, "fused and eager held-out PSNR within 1.5 dB")
    resume_cfg = Config(**{**runs["fused"]["cfg"].__dict__, "iters": TRAIN_ITERS + 200,
                           "resume": True})
    out = io.StringIO()
    fused_loss_grads.launches = fused_loss_grads.mma_launches = 0
    fused_render_rays.launches = fused_render_rays.mma_launches = 0
    with contextlib.redirect_stdout(out):
        train_mod.main(resume_cfg)
    print(out.getvalue().strip(), flush=True)
    check(f"from step {TRAIN_ITERS}" in out.getvalue() and "[resume]" in out.getvalue(),
          f"resume prints [resume] ... from step {TRAIN_ITERS}")
    resumed = {"k2": (fused_loss_grads.launches, fused_loss_grads.mma_launches),
               "k1": (fused_render_rays.launches, fused_render_rays.mma_launches)}
    print(f"[train] resume: (launches, on the tensor cores) {json.dumps(resumed)}", flush=True)
    check(resumed["k2"] == (200, 200) and resumed["k1"][0] > 0
          and resumed["k1"][0] == resumed["k1"][1],
          "the resume's 200 K2 launches and its K1 launches on the tensor cores")
    print(f"[train] ok in {time.time() - t0:.2f}s", flush=True)

    # 10. timing: plain, kernel, kernel, plain
    t0 = time.time()
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = models[dtype]
        fns = {
            "kernel": lambda m=m: fused_loss_grads(m, ro, rd, tgt, 3, **kw),
            "plain": lambda m=m: fused_loss_grads_plain(m, ro, rd, tgt, 3, **kw),
        }
        for name in ("plain", "kernel", "kernel", "plain"):
            times.setdefault((str(dtype)[6:], name), []).append(cuda_ms(fns[name]))
    ms = {k: min(v) for k, v in times.items()}
    # A reading: what each bf16 step spends packing its weights (w_fwd and
    # the forward and upstream fragments: one concatenation, one gather each).
    m = models[torch.bfloat16]
    pack_ms = [cuda_ms(lambda: pack_tiny_weights(m, m.cfg, mma=True, upstream=True))
               for _ in range(2)]
    settings = Config().train_settings()
    train_poses = poses[: n_images - 4]
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, train_poses)
    pixels = images[: n_images - 4].reshape(len(train_poses), H * W, 3)
    step_s = {}
    for name in ("eager", "fused", "fused", "eager"):
        grad_fn = make_fused_grad_fn(settings) if name == "fused" else None
        model, opt = init_train_state(torch.Generator().manual_seed(0), settings, device=dev)
        block = make_train_block(settings, TIMED_STEPS, grad_fn=grad_fn)
        block(model, opt, 0, 0, rays_o_all, rays_d_all, pixels)  # warm-up
        torch.cuda.synchronize()
        t1 = time.time()
        block(model, opt, 0, TIMED_STEPS, rays_o_all, rays_d_all, pixels)
        torch.cuda.synchronize()
        step_s.setdefault(name, []).append(TIMED_STEPS / (time.time() - t1))
    sps = {k: max(v) for k, v in step_s.items()}
    print(f"[timing] {card}: {N_RAYS_TRAIN}-ray K2 call f32 (CUDA cores) kernel "
          f"{ms['float32', 'kernel']:.4f} ms, plain {ms['float32', 'plain']:.4f} ms; bf16 (tensor "
          f"cores) kernel {ms['bfloat16', 'kernel']:.4f} ms, plain {ms['bfloat16', 'plain']:.4f} ms; "
          f"K2's weight packing of one bf16 call (reading) {min(pack_ms):.4f} ms (runs {pack_ms}) "
          f"(all runs {json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    print(f"[timing] {card}: train loop, {TIMED_STEPS} steps of {N_RAYS_TRAIN} rays, bf16: fused "
          f"{sps['fused']:.2f} steps/s ({sps['fused'] * N_RAYS_TRAIN:,.0f} rays/s), eager "
          f"{sps['eager']:.2f} steps/s ({sps['eager'] * N_RAYS_TRAIN:,.0f} rays/s) "
          f"(all runs {json.dumps(step_s)})", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    n_par = sum(p.numel() for p in models[torch.bfloat16].parameters())
    return kernel_entry(
        "fused_loss_grads", "tinynerf_tpu_torch/csrc/fused_train.cu",
        "tinynerf_tpu/kernels/fused_train.py:263", runs["fused"]["k2"],
        errs[torch.bfloat16]["max_abs"], ms["bfloat16", "kernel"], ms["bfloat16", "plain"],
        flops=2 * N_RAYS_TRAIN * N_SAMPLES * train_macs_per_point(models[torch.bfloat16]),
        nbytes=4 * (N_RAYS_TRAIN * 9 + 2 * n_par + 1))


NERF_CHUNK = 4096  # rays per hierarchical render chunk (min(chunk, 4096))
K5_GATE = 2.5e-5  # K5 vs K3 on one z, f32: see phase 13


def run_nerf(build_nerf) -> list:
    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import make_gif as gif_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays, fused_nerf_render_rays_plain, fused_render_rays_hierarchical,
        linspace_depths, pack_mma_forward, pack_nerf_weights, union_depths,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_render_rays_streamed, fused_nerf_render_rays_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads
    from tinynerf_tpu_torch.models.nerf import NeRF, render_rays_hierarchical
    from tinynerf_tpu_torch.ops.camera import spiral_poses
    from tinynerf_tpu_torch.ops.rays import get_rays
    from tinynerf_tpu_torch.render import make_hierarchical_image_renderer
    from tinynerf_tpu_torch.utils.checkpoint import save_params
    from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

    dev = torch.device("cuda", 0)
    card = card_line()
    k3, k5 = fused_nerf_render_rays, fused_nerf_render_rays_streamed

    # 11. build
    lib, secs = build_nerf.result()
    log = lib.with_suffix(".log").read_text()
    print(f"[build] fused_nerf.cu (K3, K5) -> {lib.name} in {secs:.2f}s (nvcc beside the other "
          "four)", flush=True)
    print("\n".join(line for line in log.splitlines() if "registers" in line or "spill" in line
                    or "stack frame" in line or "entry function" in line), flush=True)
    check_hmma(lib, "fused_nerf_kernel", "render kernel of K3 and K5")

    # 12. K3 against its plain version at the flagship width
    t0 = time.time()
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    hw = d["images"].shape[1:3]
    rays_o, rays_d = get_rays(*hw, focal, poses[0])
    ro, rd = rays_o[:NERF_CHUNK].contiguous(), rays_d[:NERF_CHUNK].contiguous()

    def nerf(dtype, hidden=256):
        """The flagship (the README's Quick start recipe) at `hidden`: depth 8, skip 4,
        L=10, L_dir=4, rgb_hidden 64 are the Config defaults."""
        cfg = Config(model="nerf", hidden=hidden, bf16=dtype == torch.bfloat16).nerf_cfg()
        return NeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)

    errs, models, unions = {}, {}, {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            models[dtype] = model = nerf(dtype)
            mlp, cfg = model.coarse, model.cfg
            mma0 = k3.mma_launches
            got, got_w = k3(mlp, ro, rd, n_samples=64, cfg=cfg, return_weights=True)
            torch.cuda.synchronize()
            want, want_w = fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=64, cfg=cfg,
                                                        return_weights=True)
            check(bool(torch.isfinite(got).all() and torch.isfinite(got_w).all()), "K3 (a) finite")
            errs["a", dtype] = err = ray_errors(got, want)
            err_w = ray_errors(got_w, want_w, width=64)
            print(f"[kernel] K3 {name} (a) S=64 analytic z: rgb {json.dumps(err)}; weights "
                  f"{json.dumps(err_w)}", flush=True)
            check(within(err, dtype) and within(err_w, dtype), f"K3 {name} (a) within {GATES[dtype]}")
            unions[dtype] = z = union_depths(want_w, 128, 2.0, 6.0)
            got = k3(model.fine, ro, rd, z, cfg=cfg)
            torch.cuda.synchronize()
            want = fused_nerf_render_rays_plain(model.fine, ro, rd, z, cfg=cfg)
            check(got.shape == (NERF_CHUNK, 3) and bool(torch.isfinite(got).all()), "K3 (b) finite")
            errs["b", dtype] = err = ray_errors(got, want)
            print(f"[kernel] K3 {name} (b) S=192 union: {json.dumps(err)}", flush=True)
            check(within(err, dtype), f"K3 {name} (b) within {GATES[dtype]}")
            check(k3.mma_launches - mma0 == (2 if dtype == torch.bfloat16 else 0),
                  f"K3 {name}: both launches on the cores of its dtype (bf16: the tensor cores)")
        # A reading: bf16 K4 runs the same per-point code (trunk and rgb_in
        # on the tensor cores, the 4-lane sigma head), so on the same rays
        # and depths its weights are K3's up to the deltas' rounding (K3
        # forms them in the kernel, K4 takes torch's).
        model = models[torch.bfloat16]
        z_lin = linspace_depths(64, 2.0, 6.0, dev).expand(NERF_CHUNK, 64).contiguous()
        tgt = torch.rand(NERF_CHUNK, 3, generator=torch.Generator().manual_seed(1)).to(dev)
        _, w3 = k3(model.coarse, ro, rd, z_lin, cfg=model.cfg, return_weights=True)
        _, _, w4, _ = fused_nerf_pass_grads(model.coarse, ro, rd, tgt, 0, z_lin, randomized=False,
                                            emit_sampling=True, cfg=model.cfg)
        print(f"[kernel] bf16 K3 weights vs bf16 K4 weights, flagship coarse pass, {NERF_CHUNK} "
              f"rays x 64 linspace depths (reading): {json.dumps(ray_errors(w3, w4, width=64))}",
              flush=True)
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 13. K5 against its plain version (hidden 128, S=512), and against K3
    t0 = time.time()
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            models[128, dtype] = model = nerf(dtype, hidden=128)
            _, w = fused_nerf_render_rays_plain(model.coarse, ro, rd, n_samples=64, cfg=model.cfg,
                                                return_weights=True)
            unions[128, dtype] = z = union_depths(w, 448, 2.0, 6.0)
            mma0 = k5.mma_launches
            got = k5(model.fine, ro, rd, z, cfg=model.cfg, sample_block=64)
            torch.cuda.synchronize()
            want = fused_nerf_render_rays_streamed_plain(model.fine, ro, rd, z, cfg=model.cfg,
                                                         sample_block=64)
            check(got.shape == (NERF_CHUNK, 3) and bool(torch.isfinite(got).all()), "K5 finite")
            errs["k5", dtype] = err = ray_errors(got, want)
            print(f"[kernel] K5 {name} S=512 block 64 vs plain: {json.dumps(err)}", flush=True)
            check(within(err, dtype), f"K5 {name} within {GATES[dtype]}")
            check(k5.mma_launches - mma0 == (dtype == torch.bfloat16),
                  f"K5 {name}: the launch on the cores of its dtype (bf16: the tensor cores)")
        # Same z, same MLP code (in bf16 both on the tensor cores): the
        # per-point values are equal and only the order of <= 192
        # transmittance factors and colour terms differs (<= 192 * 2^-24
        # relative each), so <= ~2.3e-5 on a colour in [0, 1].
        for dtype in (torch.float32, torch.bfloat16):
            model = models[dtype]
            mono = k3(model.fine, ro, rd, unions[dtype], cfg=model.cfg)
            stream = k5(model.fine, ro, rd, unions[dtype], cfg=model.cfg, sample_block=64)
            k5_vs_k3 = float((mono - stream).abs().max())
            print(f"[kernel] K5 vs K3 {str(dtype)[6:]} on the flagship S=192 union, block 64: max "
                  f"abs {k5_vs_k3:.3e} (gate {K5_GATE})", flush=True)
            check(k5_vs_k3 < K5_GATE, "K5 equals K3 on the same z to f32 rounding")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 14. serving: eval and make_gif on a flagship checkpoint, eval --n-fine 448
    t0 = time.time()
    ckpts = {}
    for hidden, key in ((256, torch.bfloat16), (128, (128, torch.bfloat16))):
        c = models[key].cfg
        ckpts[hidden] = os.path.join(OUT_DIR, f"nerf_h{hidden}.npz")
        save_params(ckpts[hidden], models[key], step=0, meta={"model": "nerf", "cfg": {
            "hidden": c.hidden, "depth": c.depth, "skip_at": c.skip_at, "num_freqs": c.num_freqs,
            "num_freqs_dir": c.num_freqs_dir, "rgb_hidden": c.rgb_hidden, "n_fine": 128,
            "proposal": "coarse"}})
    ckpt, ckpt128 = ckpts[256], ckpts[128]
    n_chunks = -(-hw[0] * hw[1] // NERF_CHUNK)
    def counted(run):
        """run() with every K3/K5 count set to 0 just before -> (its result,
        (K3, K5) launches, (K3, K5) launches on the tensor cores)."""
        k3.launches = k5.launches = k3.mma_launches = k5.mma_launches = 0
        out = run()
        return out, (k3.launches, k5.launches), (k3.mma_launches, k5.mma_launches)

    res, n_eval, mma_eval = counted(lambda: eval_mod.main(eval_mod.EvalConfig(
        ckpt_path=ckpt, data_path=data_path, views=2, out_dir=os.path.join(OUT_DIR, "eval_nerf"))))
    frames, n_gif, mma_gif = counted(lambda: gif_mod.main(gif_mod.GifConfig(
        ckpt_path=ckpt, data_path=data_path, n_frames=8,
        out_path=os.path.join(OUT_DIR, "nerf_views.gif"))))
    res448, n_448, mma_448 = counted(lambda: eval_mod.main(eval_mod.EvalConfig(
        ckpt_path=ckpt128, data_path=data_path, views=1, n_fine=448,
        out_dir=os.path.join(OUT_DIR, "eval_nerf448"))))
    launches = {"eval": n_eval, "make_gif": n_gif, "eval_n_fine_448": n_448}
    mma = {"eval": mma_eval, "make_gif": mma_gif, "eval_n_fine_448": mma_448}
    print(f"[serving] (K3, K5) launches {json.dumps(launches)}, of which on the tensor cores "
          f"{json.dumps(mma)}; {n_chunks} chunks per image; flagship PSNR {res['psnr_mean']:.3f} "
          f"dB, n-fine 448 PSNR {res448['psnr_mean']:.3f} dB (random weights)", flush=True)
    check(mma == launches, "every bf16 K3 and K5 launch of eval, make_gif and eval --n-fine 448 "
          "on the tensor cores")
    # eval renders each view twice (metrics, then the saved image).
    check(launches["eval"] == (2 * n_chunks * 4, 0), "eval: K3 twice per chunk, no K5")
    check(launches["make_gif"] == (2 * n_chunks * 8, 0), "make_gif: K3 twice per chunk")
    check(launches["eval_n_fine_448"] == (n_chunks * 2, n_chunks * 2),
          "eval --n-fine 448: coarse on K3, fine on K5, once per chunk each")
    check(frames.shape == (8, *hw, 3) and frames.dtype.name == "uint8", f"gif frames {frames.shape}")
    for path, n_fine in ((ckpt, None), (ckpt128, 448)):
        imgs = {}
        for fused in (True, False):
            model, renderer, _ = load_model_and_renderer(path, H=hw[0], W=hw[1], focal=focal,
                                                         fused=fused, n_fine=n_fine, device=dev)
            imgs[fused] = renderer(model, poses[0])
        check(bool(torch.isfinite(imgs[True]).all()), "served image finite")
        err = ray_errors(imgs[True], imgs[False])
        print(f"[serving] {os.path.basename(path)} n_fine={n_fine}: fused vs --no-fused image "
              f"{json.dumps(err)}", flush=True)
        check(within(err, torch.bfloat16), "served image agrees with the eager render")
    eager = make_hierarchical_image_renderer(H=hw[0], W=hw[1], focal=focal, n_fine=128,
                                             nerf_cfg=models[torch.bfloat16].cfg)
    first = spiral_poses(poses[0], n_frames=8, radius=0.3)[0]
    want = (torch.clamp(eager(models[torch.bfloat16], first), 0, 1) * 255).to(torch.uint8).cpu()
    diff = (torch.from_numpy(frames[0]).int() - want.int()).abs().reshape(-1, 3).max(dim=1).values
    frac = (diff > round(FLIP_ERR * 255)).float().mean().item()
    print(f"[serving] gif frame 0 vs eager: max {diff.max().item()} levels, fraction > "
          f"{round(FLIP_ERR * 255)} levels {frac}", flush=True)
    check(frac < GATES[torch.bfloat16]["flip"], "gif frame agrees with the eager render")
    print(f"[serving] ok in {time.time() - t0:.2f}s", flush=True)

    # 15. timing: plain, kernel, kernel, plain (bf16)
    t0 = time.time()
    model, m128 = models[torch.bfloat16], models[128, torch.bfloat16]
    cfg, z, z512 = model.cfg, unions[torch.bfloat16], unions[128, torch.bfloat16]
    hier = dict(n_coarse=64, n_fine=128, cfg=cfg)
    image = {fused: make_hierarchical_image_renderer(H=hw[0], W=hw[1], focal=focal, n_fine=128,
                                                     nerf_cfg=cfg, use_fused=fused)
             for fused in (True, False)}
    m32, m128_32 = models[torch.float32], models[128, torch.float32]
    z32, z512_32 = unions[torch.float32], unions[128, torch.float32]
    cases = {
        "chunk": {"kernel": lambda: fused_render_rays_hierarchical(model, ro, rd, **hier),
                  "plain": lambda: render_rays_hierarchical(model, ro, rd, **hier)},
        "k3_coarse": {
            "kernel": lambda: k3(model.coarse, ro, rd, cfg=cfg, return_weights=True),
            "plain": lambda: fused_nerf_render_rays_plain(model.coarse, ro, rd, cfg=cfg,
                                                          return_weights=True)},
        "k3_fine": {"kernel": lambda: k3(model.fine, ro, rd, z, cfg=cfg),
                    "plain": lambda: fused_nerf_render_rays_plain(model.fine, ro, rd, z, cfg=cfg)},
        "k5": {"kernel": lambda: k5(m128.fine, ro, rd, z512, cfg=m128.cfg, sample_block=64),
               "plain": lambda: fused_nerf_render_rays_streamed_plain(
                   m128.fine, ro, rd, z512, cfg=m128.cfg, sample_block=64)},
        "image": {"kernel": lambda: image[True](model, poses[0]),
                  "plain": lambda: image[False](model, poses[0])},
        "k3_coarse_f32": {
            "kernel": lambda: k3(m32.coarse, ro, rd, cfg=m32.cfg, return_weights=True),
            "plain": lambda: fused_nerf_render_rays_plain(m32.coarse, ro, rd, cfg=m32.cfg,
                                                          return_weights=True)},
        "k3_fine_f32": {
            "kernel": lambda: k3(m32.fine, ro, rd, z32, cfg=m32.cfg),
            "plain": lambda: fused_nerf_render_rays_plain(m32.fine, ro, rd, z32, cfg=m32.cfg)},
        "k5_f32": {
            "kernel": lambda: k5(m128_32.fine, ro, rd, z512_32, cfg=m128_32.cfg, sample_block=64),
            "plain": lambda: fused_nerf_render_rays_streamed_plain(
                m128_32.fine, ro, rd, z512_32, cfg=m128_32.cfg, sample_block=64)},
    }
    times = {}
    with torch.no_grad():
        for what, fns in cases.items():
            for name in ("plain", "kernel", "kernel", "plain"):
                times.setdefault((what, name), []).append(cuda_ms(fns[name], iters=5))
        # A reading: what each bf16 K3 fine call spends packing its weights
        # (the f32 buffer and the tensor-core fragments), alone.
        pack_ms = [cuda_ms(lambda: (pack_nerf_weights(model.fine, cfg),
                                    pack_mma_forward(model.fine, cfg))) for _ in range(2)]
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: bf16, {NERF_CHUNK} rays; flagship hierarchical chunk fused "
          f"{ms['chunk', 'kernel']:.4f} ms, eager {ms['chunk', 'plain']:.4f} ms; K3 coarse (S=64, "
          f"weights) {ms['k3_coarse', 'kernel']:.4f} ms, plain {ms['k3_coarse', 'plain']:.4f} ms; "
          f"K3 fine (S=192) {ms['k3_fine', 'kernel']:.4f} ms, plain {ms['k3_fine', 'plain']:.4f} ms; "
          f"K5 (hidden 128, S=512) {ms['k5', 'kernel']:.4f} ms, plain {ms['k5', 'plain']:.4f} ms; "
          f"{hw[0]}x{hw[1]} flagship image fused {ms['image', 'kernel']:.4f} ms, eager "
          f"{ms['image', 'plain']:.4f} ms "
          f"(all runs {json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    print(f"[timing] {card}: f32 (the CUDA cores), {NERF_CHUNK} rays; K3 coarse "
          f"{ms['k3_coarse_f32', 'kernel']:.4f} ms, plain {ms['k3_coarse_f32', 'plain']:.4f} ms; "
          f"K3 fine {ms['k3_fine_f32', 'kernel']:.4f} ms, plain {ms['k3_fine_f32', 'plain']:.4f} "
          f"ms; K5 {ms['k5_f32', 'kernel']:.4f} ms, plain {ms['k5_f32', 'plain']:.4f} ms. Weight "
          f"packing of one bf16 K3 fine call (reading): {min(pack_ms):.4f} ms (runs {pack_ms})",
          flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    bf16 = torch.bfloat16
    mlp_par = sum(p.numel() for p in model.fine.parameters())
    mlp128_par = sum(p.numel() for p in m128.fine.parameters())
    s_fine, s512 = z.shape[1], z512.shape[1]
    return [
        kernel_entry(
            "fused_nerf_render_rays", "tinynerf_tpu_torch/csrc/fused_nerf.cu",
            "tinynerf_tpu/kernels/fused_nerf.py:183",
            launches["eval"][0] + launches["make_gif"][0],
            max(errs["a", bf16]["max"], errs["b", bf16]["max"]),
            ms["k3_fine", "kernel"], ms["k3_fine", "plain"],
            flops=2 * NERF_CHUNK * s_fine * macs_per_point(model.fine),
            nbytes=4 * (NERF_CHUNK * (6 + s_fine + 3) + mlp_par)),
        kernel_entry(
            "fused_nerf_render_rays_streamed", "tinynerf_tpu_torch/csrc/fused_nerf.cu",
            "tinynerf_tpu/kernels/fused_nerf_stream.py:451", launches["eval_n_fine_448"][1],
            errs["k5", bf16]["max"], ms["k5", "kernel"], ms["k5", "plain"],
            flops=2 * NERF_CHUNK * s512 * macs_per_point(m128.fine),
            nbytes=4 * (NERF_CHUNK * (6 + s512 + 3) + mlp128_par)),
    ]


NERF_TRAIN_ITERS = 500  # hidden 128: both passes through K4
FLAGSHIP_ITERS = 20  # hidden 256, n_fine 128: coarse K4, fine K6


def run_nerf_train(build_nerf_train) -> list:
    import copy

    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays, fused_nerf_render_rays_plain, union_depths,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed, fused_nerf_pass_grads_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads, fused_nerf_pass_grads_plain, make_fused_nerf_grad_fn,
    )
    from tinynerf_tpu_torch.kernels.fused_train import depth_grid
    from tinynerf_tpu_torch.models.nerf import NeRF, make_hierarchical_loss, render_rays_hierarchical
    from tinynerf_tpu_torch.ops.rays import get_rays, get_rays_for_poses
    from tinynerf_tpu_torch.training import make_optimizer, make_train_step

    dev = torch.device("cuda", 0)
    card = card_line()
    k4, k6 = fused_nerf_pass_grads, fused_nerf_pass_grads_streamed

    # 16. build
    lib, secs = build_nerf_train.result()
    log = lib.with_suffix(".log").read_text()
    print(f"[build] fused_nerf_train.cu (K4, K6) -> {lib.name} in {secs:.2f}s (nvcc beside the "
          "other three)", flush=True)
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "spill" in line or "stack frame" in line), flush=True)
    hmma = sass_counts(lib, "HMMA")
    print(f"[build] HMMA instructions per kernel (cuobjdump -sass): {json.dumps(hmma)}", flush=True)
    walks = walk_hmma(hmma)
    check(len(walks) == 8 and all((n > 0) == mma for mma, _, n in walks),
          "the bf16 walks of K4 and K6 (kMma=true, one-round and general) hold HMMA instructions; "
          "the CUDA-core walks none")

    # 17. K4 against its plain version: the flagship coarse pass and a
    #     hidden-128 fine pass, on 2048 rays of a synthetic view.
    t0 = time.time()
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    rays_o, rays_d = get_rays(H, W, focal, poses[0])
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:N_RAYS_TRAIN].to(dev)
    ro, rd = rays_o[idx].contiguous(), rays_d[idx].contiguous()
    tgt = images[0].reshape(-1, 3)[idx].contiguous()
    noise = torch.randn(N_RAYS_TRAIN, 64, generator=torch.Generator(device=dev).manual_seed(4),
                        device=dev)

    def nerf(dtype, hidden=256):
        """The flagship recipe (README's Quick start) at `hidden`."""
        cfg = Config(model="nerf", hidden=hidden, bf16=dtype == torch.bfloat16).nerf_cfg()
        return NeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)

    def reference(fn, mlp, *args, dtype, **kw):
        """The plain version's (loss, grads, slack). bf16: as it is, slack
        None. f32: on a float64 copy of the MLP (float64 sums; the points,
        the encoding and the deltas stay f32), with slack = each leaf's
        max |f32 plain - float64 plain|: the error the straightforward f32
        evaluation itself makes, which the kernel may match. At a 64-sample
        pass f32 evaluation moves a tiny early-layer leaf by ~5e-4 of its
        max; at a 192-sample union the f32 plain version's rounding of the
        density gradient's cancellation moves the sigma head's leaves by
        ~3e-4 (the kernel's recurrence stays within 1e-5 there). The gate
        allows the slack capped at 3e-4 of the leaf's max: at most twice
        the JAX package's tolerance."""
        if dtype == torch.bfloat16:
            out = fn(mlp, *args, **kw)
            return out[0], out[1], None
        out32 = fn(mlp, *args, **kw)
        out = fn(copy.deepcopy(mlp).double(), *args, **kw)
        want = [g.float() for g in out[1]]
        slack = [float((a - b).abs().max()) for a, b in zip(out32[1], want)]
        return out[0].float(), want, slack

    def grad_gates(what, dtype, mlp, loss, grads, ref):
        """bf16 runs on the tensor cores: its tensor-core leaves are also
        held to MMA_SCALE."""
        want_loss, want, slack = ref
        rel = abs(float(loss) - float(want_loss)) / float(want_loss)
        err = {"loss": float(loss), "loss_rel": rel, **leaf_errors(grads, want)}
        names = [n for n, _ in mlp.named_parameters()]
        leaf = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(grads, want)]
        err["worst_leaf"] = names[max(range(len(leaf)), key=leaf.__getitem__)]
        check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads),
              f"{what}: loss and gradients finite")
        if dtype == torch.float32:
            top = [max(w.abs().max().item(), 1e-30) for w in want]
            tol = [3e-4 * m for m in top]
            gap = [(g - w).abs().max().item() for g, w in zip(grads, want)]
            err["f32_plain_max_rel_to_leaf"] = max(sl / m for m, sl in zip(top, slack))
            # The leaves that pass only through the f32 plain version's own
            # error, each with (kernel, f32 plain) error over its max.
            err["on_allowance"] = {n: [e / m, sl / m]
                                   for n, e, m, t, sl in zip(names, gap, top, tol, slack) if e > t}
            print(f"[kernel] {what} f32: {json.dumps(err)}", flush=True)
            check(rel < 1e-5 and all(e <= t + min(sl, t) for e, t, sl in zip(gap, tol, slack)),
                  f"{what} f32: loss rel < 1e-5; per leaf |err| <= 3e-4 max|leaf| + the f32 "
                  "plain version's own |err| (at most another 3e-4 max|leaf|), both against "
                  "float64 sums")
        else:
            err["mma_scale_err"] = mma_scale_error(names, grads, want)
            print(f"[kernel] {what} bf16: {json.dumps(err)}", flush=True)
            check(rel < 1e-3 and err["min_cosine"] > 0.98,
                  f"{what} bf16: loss rel < 1e-3, per-leaf cosine > 0.98")
            check(err["mma_scale_err"] < MMA_SCALE,
                  f"{what} bf16: each tensor-core leaf's scale within {MMA_SCALE} of 1")
        return err

    def through_k4(*args, dtype, **kw):
        """K4 once, checking that it took the tensor-core walk in bf16 only."""
        mma = k4.mma_launches
        out = k4(*args, **kw)
        torch.cuda.synchronize()
        check(k4.mma_launches - mma == int(dtype == torch.bfloat16),
              "K4: the tensor-core walk in bf16, the CUDA cores in f32")
        return out

    errs, models, unions = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        models[dtype] = m = nerf(dtype)
        for sn in (None, noise):
            what = "K4 (a) flagship coarse S=64" + (" + sigma-noise" if sn is not None else "")
            kw = dict(n_samples=64, randomized=False, emit_sampling=True, sigma_noise=sn)
            loss, grads, w, zs = through_k4(m.coarse, ro, rd, tgt, 0, dtype=dtype, **kw)
            ref = reference(fused_nerf_pass_grads_plain, m.coarse, ro, rd, tgt, 0, dtype=dtype,
                            **kw)
            _, _, want_w, want_z = fused_nerf_pass_grads_plain(m.coarse, ro, rd, tgt, 0, **kw)
            errs["a", dtype, sn is None] = grad_gates(what, dtype, m.coarse, loss, grads, ref)
            if dtype == torch.float32 and sn is None:
                # A second f32 ordering of the plain version, on the host's
                # CPU, against the same float64 sums: whether the slack
                # belongs to f32 evaluation or to one ordering of it.
                t1 = time.time()
                host = fused_nerf_pass_grads_plain(copy.deepcopy(m.coarse).cpu(), ro.cpu(),
                                                   rd.cpu(), tgt.cpu(), 0, **kw)[1]
                names = [n for n, _ in m.coarse.named_parameters()]
                rel = {n: [sl / max(float(w.abs().max()), 1e-30),
                           float((c.to(dev) - w).abs().max()) / max(float(w.abs().max()), 1e-30)]
                       for n, c, w, sl in zip(names, host, ref[1], ref[2])}
                worst = sorted(rel, key=lambda n: -max(rel[n]))[:3]
                print(f"[kernel] {what} f32 plain vs float64 sums, per-leaf max |err| over the "
                      f"leaf's max, [CUDA, CPU]: {json.dumps({n: rel[n] for n in worst})} "
                      f"({time.time() - t1:.1f}s)", flush=True)
            err_w = ray_errors(w, want_w, width=64)
            print(f"[kernel] {what} {str(dtype)[6:]}: weights {json.dumps(err_w)}", flush=True)
            check(torch.equal(zs, want_z) and within(err_w, dtype), f"{what}: weights and z")
        with torch.no_grad():
            _, w = fused_nerf_render_rays_plain(m.coarse, ro, rd, n_samples=64, return_weights=True)
        unions[dtype] = union_depths(w, 128, 2.0, 6.0)
        models[128, dtype] = m = nerf(dtype, hidden=128)
        with torch.no_grad():
            _, w = fused_nerf_render_rays_plain(m.coarse, ro, rd, n_samples=64, return_weights=True)
        unions[128, dtype] = z = union_depths(w, 64, 2.0, 6.0)
        unions[512, dtype] = union_depths(w, 448, 2.0, 6.0)
        loss, grads = through_k4(m.fine, ro, rd, tgt, 0, z, randomized=False, dtype=dtype)
        ref = reference(fused_nerf_pass_grads_plain, m.fine, ro, rd, tgt, 0, z, randomized=False,
                        dtype=dtype)
        errs["b", dtype] = grad_gates("K4 (b) hidden-128 fine pass, S=128 union", dtype, m.fine,
                                      loss, grads, ref)
        # (c) the hidden-128 train's coarse pass: jittered in the kernel,
        # held against the plain version on the depths the kernel emitted.
        loss, grads, _, zj = through_k4(m.coarse, ro, rd, tgt, 7, n_samples=64,
                                        emit_sampling=True, dtype=dtype)
        ref = reference(fused_nerf_pass_grads_plain, m.coarse, ro, rd, tgt, 0, zj,
                        randomized=False, dtype=dtype)
        errs["c", dtype] = grad_gates("K4 (c) hidden-128 coarse pass, S=64 jittered in the kernel",
                                      dtype, m.coarse, loss, grads, ref)
    m = models[torch.bfloat16]
    runs = []
    for seed in (11, 11, 12):
        loss, grads, _, zs = k4(m.coarse, ro, rd, tgt, seed, n_samples=64, emit_sampling=True)
        runs.append((float(loss), [g.clone() for g in grads], zs.clone()))
    same = (runs[0][0] == runs[1][0] and torch.equal(runs[0][2], runs[1][2])
            and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])))
    differ = runs[0][0] != runs[2][0] and not torch.equal(runs[0][2], runs[2][2])
    print(f"[kernel] K4 jittered, bf16 (tensor cores): seed 11 twice bit-identical {same}, seed 12 "
          f"differs {differ}", flush=True)
    check(same and differ, "K4 deterministic per seed, different across seeds")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 18. jitter statistics of the depths K4 draws and emits
    t0 = time.time()
    R, S = 16384, 64
    tiny = NeRF(Config(model="nerf", hidden=32, num_freqs=4, num_freqs_dir=2, nerf_depth=3,
                       nerf_skip_at=2, rgb_hidden=16).nerf_cfg(),
                generator=torch.Generator().manual_seed(0), device=dev)
    o0 = torch.zeros(R, 3, device=dev)
    d0 = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(R, 3).contiguous()
    t0_ = torch.full((R, 3), 0.5, device=dev)

    def draws(seed):
        return k4(tiny.coarse, o0, d0, t0_, seed, n_samples=S, emit_sampling=True)[3]

    z = draws(123)
    h = 4.0 / (S - 1)
    grid = depth_grid(S, 2.0, 6.0, dev)
    s_idx = torch.arange(S, device=dev)
    lower = torch.where(s_idx == 0, grid, grid - 0.5 * h)
    upper = torch.where(s_idx == S - 1, grid, grid + 0.5 * h)
    u = ((z - lower) / (upper - lower)).double()
    n = u.numel()
    deciles = (torch.histc(u.float(), bins=10, min=0.0, max=1.0) / n).tolist()
    corr = float(torch.corrcoef(torch.stack([u[:-1].reshape(-1), u[1:].reshape(-1)]))[0, 1])
    stats = {
        "in_bin": bool(((z >= lower) & (z <= upper)).all()),
        "mean": float(u.mean()), "var": float(u.var()), "deciles": deciles,
        "adjacent_tile_corr": corr, "replay": bool(torch.equal(z, draws(123))),
        "new_seed_changed": float((z != draws(124)).float().mean()),
    }
    print(f"[jitter] K4 {R}x{S} draws: {json.dumps(stats)}", flush=True)
    # Gates at 6 standard errors of each statistic for n uniform draws.
    check(stats["in_bin"], "every z in its bin")
    check(abs(stats["mean"] - 0.5) < 6 / (12 * n) ** 0.5, "mean of u")
    check(abs(stats["var"] - 1 / 12) < 6 * (1 / 180 / n) ** 0.5, "variance of u")
    check(max(abs(q - 0.1) for q in deciles) < 6 * (0.09 / n) ** 0.5, "deciles of u")
    check(abs(corr) < 6 / n ** 0.5, "adjacent ray tiles uncorrelated")
    check(stats["replay"] and stats["new_seed_changed"] > 0.99, "seed replay, new seed")
    print(f"[jitter] ok in {time.time() - t0:.2f}s", flush=True)

    # 19. K6 against its plain version and against K4; the whole fused step
    t0 = time.time()
    for dtype in (torch.float32, torch.bfloat16):
        for key, mlp, label in ((dtype, models[dtype].fine, "flagship fine, S=192 union"),
                                (512, models[128, dtype].fine, "hidden 128, S=512 union")):
            z = unions[key] if key == dtype else unions[512, dtype]
            mma = k6.mma_launches
            loss, grads = k6(mlp, ro, rd, tgt, z, sample_block=64)
            torch.cuda.synchronize()
            check(k6.mma_launches - mma == int(dtype == torch.bfloat16),
                  f"K6 {label}: the tensor-core walk in bf16 only")
            ref = reference(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, tgt, z,
                            sample_block=64, dtype=dtype)
            errs["k6", key == dtype, dtype] = grad_gates(f"K6 {label}, block 64", dtype, mlp,
                                                         loss, grads, ref)
    # Same union, same MLP code, the same transmittance and density
    # recurrences: only the order of the gradient partials differs. The JAX
    # package's gates for the pair (tests/test_fused_nerf_stream.py:117-128).
    m, z = models[torch.float32], unions[torch.float32]
    l4, g4 = k4(m.fine, ro, rd, tgt, 0, z, randomized=False)
    l6, g6 = k6(m.fine, ro, rd, tgt, z, sample_block=64)
    k6_vs_k4 = {"loss_rel": abs(float(l6) - float(l4)) / float(l4), **leaf_errors(g6, g4)}
    print(f"[kernel] K6 vs K4 f32 on the flagship S=192 union: {json.dumps(k6_vs_k4)}", flush=True)
    check(k6_vs_k4["loss_rel"] <= 1e-6 and k6_vs_k4["max_rel_to_leaf"] <= 1e-5,
          "K6 equals K4 on one union: loss rel <= 1e-6, per-leaf <= 1e-5 max|leaf|")
    # The whole step against autograd of the eager hierarchical loss, bf16
    # (the training dtype): at the flagship's L=10 the 2^9 x encoding bands
    # turn the last-bit difference of the coarse depths (the kernel's
    # near + s*h grid, the eager linspace) into f32 gradient differences,
    # so the step is held to bench.py's bf16 gates.
    m = models[torch.bfloat16]
    settings = Config(model="nerf", hidden=256, n_fine=128).train_settings()
    grad_fn = make_fused_nerf_grad_fn(settings, m.cfg, n_fine=128, randomized=False)
    k4.launches = k4.mma_launches = k6.launches = k6.mma_launches = 0
    loss_f, metrics = grad_fn(m, ro, rd, tgt, torch.Generator(device=dev))
    step_launches = (k4.launches, k4.mma_launches, k6.launches, k6.mma_launches)
    got = [p.grad.clone() for p in m.parameters()]
    comp_c, comp_f = render_rays_hierarchical(m, ro, rd, n_coarse=64, n_fine=128, cfg=m.cfg)
    ref = torch.mean((comp_c - tgt) ** 2) + torch.mean((comp_f - tgt) ** 2)
    want = torch.autograd.grad(ref, list(m.parameters()))
    ref = ref.detach()
    step_err = {"loss_rel": abs(float(metrics["loss_coarse"]) + float(loss_f) - float(ref))
                / float(ref), "launches": step_launches, **leaf_errors(got, want),
                "mma_scale_err": mma_scale_error([n for n, _ in m.named_parameters()], got, want)}
    print(f"[kernel] flagship fused step vs eager autograd, bf16: {json.dumps(step_err)}",
          flush=True)
    check(step_launches == (1, 1, 1, 1),
          "the flagship step runs K4 (coarse) and K6 (fine) once, both on the tensor cores")
    check(step_err["loss_rel"] < 1e-3 and step_err["min_cosine"] > 0.98,
          "fused step vs eager: loss rel < 1e-3, per-leaf cosine > 0.98")
    check(step_err["mma_scale_err"] < MMA_SCALE,
          f"fused step vs eager: each trunk and rgb_in leaf's scale within {MMA_SCALE} of 1")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 20. the train path: python -m tinynerf_tpu_torch.train --model nerf
    t0 = time.time()
    runs = {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        cfg = Config(model="nerf", data_path=data_path, iters=NERF_TRAIN_ITERS, holdout=4,
                     resume=False, out_dir=os.path.join(OUT_DIR, f"nerf_{name}"),
                     ckpt_path=os.path.join(OUT_DIR, f"nerf_{name}.npz"),
                     metrics_path=os.path.join(OUT_DIR, f"nerf_{name}.jsonl"), fused_train=fused)
        if os.path.exists(cfg.metrics_path):
            os.unlink(cfg.metrics_path)
        k4.launches = k4.mma_launches = k6.launches = fused_nerf_render_rays.launches = 0
        res = train_mod.main(cfg)
        psnrs = logged_psnrs(cfg.metrics_path)
        runs[name] = {"k4": k4.launches, "k4_mma": k4.mma_launches, "k6": k6.launches,
                      "k3": fused_nerf_render_rays.launches,
                      "rise": psnrs[-1] - psnrs[0], "heldout": res["eval"]["psnr_mean"],
                      "rays_per_sec": res["rays_per_sec"]}
        print(f"[train] nerf hidden 128 {name}: (K4, K4 on the tensor cores, K6, K3) launches "
              f"({k4.launches}, {k4.mma_launches}, {k6.launches}, "
              f"{fused_nerf_render_rays.launches}), train PSNR {psnrs[0]:.2f} -> "
              f"{psnrs[-1]:.2f} dB, held-out {res['eval']['psnr_mean']:.2f} dB, "
              f"{res['rays_per_sec']:,.0f} rays/s", flush=True)
        check(runs[name]["rise"] >= 2.0, f"{name} nerf train PSNR rises >= 2 dB")
    check(runs["fused"]["k4"] == runs["fused"]["k4_mma"] == 2 * NERF_TRAIN_ITERS
          and runs["fused"]["k6"] == 0,
          "fused nerf run: K4 twice per step (coarse and fine), every launch on the tensor cores; "
          "no K6")
    check(runs["eager"]["k4"] == 0 and runs["fused"]["k3"] > 0, "eager run: no K4; K3 renders")
    gap = abs(runs["fused"]["heldout"] - runs["eager"]["heldout"])
    print(f"[train] nerf held-out PSNR fused vs eager: {gap:.3f} dB apart", flush=True)
    check(gap <= 1.5, "fused and eager held-out PSNR within 1.5 dB")
    flag = Config(model="nerf", hidden=256, n_fine=128, data_path=data_path, iters=FLAGSHIP_ITERS,
                  holdout=4, resume=False, log_every=10, out_dir=os.path.join(OUT_DIR, "flagship"),
                  ckpt_path=os.path.join(OUT_DIR, "flagship.npz"),
                  metrics_path=os.path.join(OUT_DIR, "flagship.jsonl"))
    if os.path.exists(flag.metrics_path):
        os.unlink(flag.metrics_path)
    k4.launches = k4.mma_launches = k6.launches = k6.mma_launches = 0
    res = train_mod.main(flag)
    flag_launches = (k4.launches, k4.mma_launches, k6.launches, k6.mma_launches)
    losses = [r["loss"] for r in map(json.loads, open(flag.metrics_path)) if "loss" in r]
    runs["flagship"] = {"rays_per_sec": res["rays_per_sec"]}
    print(f"[train] flagship {FLAGSHIP_ITERS} steps: (K4, K4 on the tensor cores, K6, K6 on the "
          f"tensor cores) launches {flag_launches}, losses "
          f"{losses}, {res['rays_per_sec']:,.0f} rays/s", flush=True)
    check(flag_launches == (FLAGSHIP_ITERS,) * 4,
          "flagship: K4 (coarse) and K6 (fine) once per step, every launch on the tensor cores")
    check(all(math.isfinite(x) for x in losses), "flagship losses finite")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main(Config(**{**flag.__dict__, "iters": FLAGSHIP_ITERS + 5, "resume": True}))
    print(out.getvalue().strip(), flush=True)
    check(f"from step {FLAGSHIP_ITERS}" in out.getvalue() and "[resume]" in out.getvalue(),
          f"resume prints [resume] ... from step {FLAGSHIP_ITERS}")
    fused_nerf_render_rays.launches = fused_nerf_render_rays.mma_launches = 0
    ev = eval_mod.main(eval_mod.EvalConfig(ckpt_path=flag.ckpt_path, data_path=data_path, views=2,
                                           out_dir=os.path.join(OUT_DIR, "eval_flagship")))
    k3_launches = (fused_nerf_render_rays.launches, fused_nerf_render_rays.mma_launches)
    print(f"[train] eval of the flagship checkpoint: (K3, K3 on the tensor cores) launches "
          f"{k3_launches}, PSNR {ev['psnr_mean']:.3f} dB", flush=True)
    check(k3_launches[0] > 0 and k3_launches[0] == k3_launches[1]
          and math.isfinite(ev["psnr_mean"]),
          "eval serves the trained flagship checkpoint through K3, on the tensor cores")
    print(f"[train] ok in {time.time() - t0:.2f}s", flush=True)

    # 21. timing: plain, kernel, kernel, plain (bf16, flagship)
    t0 = time.time()
    m, z = models[torch.bfloat16], unions[torch.bfloat16]
    # The train step hands K4 its seed on the device; an int seed costs a
    # blocking host-to-device copy, a stream sync, each call.
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    cases = {
        "k4": {"kernel": lambda: k4(m.coarse, ro, rd, tgt, seed, n_samples=64, emit_sampling=True),
               "plain": lambda: fused_nerf_pass_grads_plain(m.coarse, ro, rd, tgt, 3, n_samples=64,
                                                            emit_sampling=True)},
        "k6": {"kernel": lambda: k6(m.fine, ro, rd, tgt, z, sample_block=64),
               "plain": lambda: fused_nerf_pass_grads_streamed_plain(m.fine, ro, rd, tgt, z,
                                                                    sample_block=64)},
    }
    train_poses = poses[: n_images - 4]
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, train_poses)
    pixels = images[: n_images - 4].reshape(len(train_poses), H * W, 3)
    step_fns = {
        "kernel": make_train_step(settings, grad_fn=make_fused_nerf_grad_fn(settings, m.cfg,
                                                                            n_fine=128)),
        "plain": make_train_step(settings, loss=make_hierarchical_loss(m.cfg, n_fine=128)),
    }
    step_model = copy.deepcopy(m)
    step_opt = make_optimizer(step_model.parameters(), settings.lr)
    counter = iter(range(10**6))
    cases["step"] = {k: (lambda f=f: f(step_model, step_opt, 0, next(counter), rays_o_all,
                                       rays_d_all, pixels)) for k, f in step_fns.items()}
    # K4 on the same fine union (one segment of 192 samples), both on the
    # tensor cores: a reading beside K6 for the fine pass's route (ROADMAP
    # R1a); the route is the JAX package's and stays.
    cases["k4_union"] = {"kernel": lambda: k4(m.fine, ro, rd, tgt, seed, z, randomized=False)}
    # K4 with an int seed, as a reading: the price of that sync.
    cases["k4_int_seed"] = {"kernel": lambda: k4(m.coarse, ro, rd, tgt, 3, n_samples=64,
                                                 emit_sampling=True)}
    times = {}
    for what, fns in cases.items():
        for name in ("plain", "kernel", "kernel", "plain"):
            if name in fns:
                times.setdefault((what, name), []).append(cuda_ms(fns[name], iters=3))
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: bf16 (tensor cores), {N_RAYS_TRAIN} rays; flagship K4 coarse (S=64, "
          f"weights and z out) {ms['k4', 'kernel']:.4f} ms, plain {ms['k4', 'plain']:.4f} ms; K6 "
          f"fine (S=192, block 64) {ms['k6', 'kernel']:.4f} ms, plain {ms['k6', 'plain']:.4f} ms; "
          f"K4 on the same union (reading only) {ms['k4_union', 'kernel']:.4f} ms; K4 coarse with an "
          f"int seed (reading only) {ms['k4_int_seed', 'kernel']:.4f} ms; flagship train "
          f"step fused {ms['step', 'kernel']:.4f} ms, eager {ms['step', 'plain']:.4f} ms "
          f"(all runs {json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    print(f"[timing] {card}: nerf hidden 128 train loop, {NERF_TRAIN_ITERS} steps of "
          f"{N_RAYS_TRAIN} rays: fused {runs['fused']['rays_per_sec'] / N_RAYS_TRAIN:.2f} steps/s "
          f"({runs['fused']['rays_per_sec']:,.0f} rays/s), eager "
          f"{runs['eager']['rays_per_sec'] / N_RAYS_TRAIN:.2f} steps/s "
          f"({runs['eager']['rays_per_sec']:,.0f} rays/s); flagship fused "
          f"{runs['flagship']['rays_per_sec'] / N_RAYS_TRAIN:.2f} steps/s", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    bf16 = torch.bfloat16
    mlp_par = sum(p.numel() for p in m.coarse.parameters())
    s_fine = z.shape[1]
    pass_bytes = 4 * (N_RAYS_TRAIN * 9 + 2 * mlp_par + 1)  # rays, target, weights in; grads out
    return [
        kernel_entry(
            "fused_nerf_pass_grads", "tinynerf_tpu_torch/csrc/fused_nerf_train.cu",
            "tinynerf_tpu/kernels/fused_nerf_train.py:344", runs["fused"]["k4"],
            errs["a", bf16, True]["max_abs"], ms["k4", "kernel"], ms["k4", "plain"],
            flops=2 * N_RAYS_TRAIN * 64 * train_macs_per_point(m.coarse),
            nbytes=pass_bytes + 4 * 2 * N_RAYS_TRAIN * 64),  # + weights and z out
        kernel_entry(
            "fused_nerf_pass_grads_streamed", "tinynerf_tpu_torch/csrc/fused_nerf_train.cu",
            "tinynerf_tpu/kernels/fused_nerf_stream.py:548", flag_launches[1],
            errs["k6", True, bf16]["max_abs"], ms["k6", "kernel"], ms["k6", "plain"],
            flops=2 * N_RAYS_TRAIN * s_fine * train_macs_per_point(m.fine),
            nbytes=pass_bytes + 4 * N_RAYS_TRAIN * s_fine),  # + z in
    ]


SP_ITERS = 20  # the 2-rank flagship sample-parallel train (K7), then a resume to +5
DP_ITERS = 10  # the 2-rank flagship data-parallel train (K4 and K6 on each rank)
PARTIAL_KEYS = ("C", "A", "T", "D")


def sharded_pass_case(mesh, inputs: dict, dev) -> dict:
    """Phase 24 (c), through K7 on `mesh`: the flagship f32 coarse pass's
    composite and global weights on z_c, and the fine pass's MSE on z_f
    with its gradients mean-reduced over the sample axis."""
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.models.nerf import NeRF
    from tinynerf_tpu_torch.parallel.mesh import SAMPLE_AXIS
    from tinynerf_tpu_torch.parallel.train import mean_over, sharded_pass

    cfg = Config(model="nerf", hidden=256, bf16=False).nerf_cfg()
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    ro, rd, tgt, z_c, z_f = (inputs[k].to(dev) for k in ("ro", "rd", "tgt", "z_c", "z_f"))
    with torch.no_grad():
        comp_c, w_c = sharded_pass(model.coarse, ro, rd, z_c, mesh, cfg, need_weights=True,
                                   fused_kernels=True)
    comp_f, _ = sharded_pass(model.fine, ro, rd, z_f, mesh, cfg, fused_kernels=True)
    loss = torch.mean((comp_f - tgt) ** 2)
    grads = torch.autograd.grad(loss, list(model.fine.parameters()))
    flat = mean_over(torch.cat([g.reshape(-1) for g in grads]), mesh, (SAMPLE_AXIS,))
    return {"comp_c": comp_c.cpu(), "w_c": w_c.cpu(), "comp_f": comp_f.detach().cpu(),
            "loss": float(loss), "grads": flat.cpu().split([g.numel() for g in grads])}


def sharded_pass_rank(rank: int, world: int, init: str, path: str) -> None:
    """Phase 24 (c): one rank of a world-2 sharded pass. Both ranks use
    card 0, so the collectives take gloo (parallel/mesh.py's rule)."""
    import torch.distributed as dist

    from tinynerf_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    initialize_distributed(init_method=init, world_size=world, rank=rank, backend="gloo")
    out = sharded_pass_case(make_mesh(sample_parallel=world), torch.load(path), dev)
    torch.save(out, f"{path}.rank{rank}")
    dist.destroy_process_group()


def torchrun_train(tag: str, *args: str) -> dict:
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    tinynerf_tpu_torch.train ...` at the flagship width on the one card ->
    its output, each rank's kernel launches and the rays/s of its [done]
    line. Fails unless every rank exits 0 with the same parameter
    digest."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "tinynerf_tpu_torch.train", "--model", "nerf", "--hidden", "256", "--n-fine", "128",
           "--data-parallel", "--data-path", os.path.join(OUT_DIR, "absent.npz"), "--holdout", "4",
           "--log-every", "10", "--out-dir", os.path.join(OUT_DIR, tag),
           "--ckpt-path", os.path.join(OUT_DIR, f"{tag}.npz"), *args]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": os.getcwd()})
    out = proc.stdout + proc.stderr
    with open(os.path.join(OUT_DIR, f"{tag}.log"), "w") as f:
        f.write(out)
    keep = ("[distributed]", "[train] step", "[train] mesh", "[train] fused", "[resume]", "[eval]",
            "[done]", "Error", "error")
    print("\n".join(line for line in out.splitlines() if any(k in line for k in keep)), flush=True)
    check(proc.returncode == 0, f"{tag}: every rank exits 0 (rc {proc.returncode})")
    ranks = [line.split("parameter digest ")[1] for line in out.splitlines()
             if "parameter digest" in line]
    digests = {r.split(",")[0] for r in ranks}
    check(len(ranks) == 2 and len(digests) == 1, f"{tag}: both ranks' parameters bit-identical")
    done = [line for line in out.splitlines() if line.startswith("[done]")]
    rays = float(done[0].split(" rays/s")[0].split(", ")[-1].replace(",", ""))
    return {"out": out, "launches": [json.loads(r.split("kernel launches ")[1]) for r in ranks],
            "rays_per_sec": rays}


def run_partials(build_partials) -> list:
    import copy

    import torch.multiprocessing as mp

    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays, fused_nerf_render_rays_plain, linspace_depths, union_depths,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed, fused_nerf_pass_grads_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain, block_partials_plain, fused_block_partials_bwd,
        fused_block_partials_fwd, make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.models.nerf import NeRF
    from tinynerf_tpu_torch.ops.rays import get_rays, get_rays_for_poses
    from tinynerf_tpu_torch.ops.volume import combine_block_partials, global_deltas
    from tinynerf_tpu_torch.parallel.mesh import make_mesh
    from tinynerf_tpu_torch.parallel.train import make_sharded_train_block
    from tinynerf_tpu_torch.training import make_optimizer

    dev = torch.device("cuda", 0)
    card = card_line()
    fwd, bwd = fused_block_partials_fwd, fused_block_partials_bwd
    f32, bf16 = torch.float32, torch.bfloat16

    # 22. build
    lib, secs = build_partials.result()
    log = lib.with_suffix(".log").read_text()
    print(f"[build] fused_partials.cu (K7 forward, backward) -> {lib.name} in {secs:.2f}s (nvcc "
          "beside the other four)", flush=True)
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "spill" in line or "stack frame" in line), flush=True)
    hmma = sass_counts(lib, "HMMA")
    print(f"[build] HMMA instructions per kernel (cuobjdump -sass): {json.dumps(hmma)}", flush=True)
    walks = walk_hmma(hmma)
    check(len(walks) == 8 and all((n > 0) == mma for mma, _, n in walks),
          "K7's bf16 forward and backward walks (kMma=true, one-round and general) hold HMMA "
          "instructions; the CUDA-core walks none")

    # 23. K7 against its plain versions: both shards of the flagship's coarse
    #     (2 x 32, weights out) and fine (2 x 96, block 48, sigma-noise)
    #     passes at world 2, on 2048 rays of a synthetic view.
    t0 = time.time()
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    rays_o, rays_d = get_rays(H, W, focal, poses[0])
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:N_RAYS_TRAIN].to(dev)
    ro, rd = rays_o[idx].contiguous(), rays_d[idx].contiguous()
    tgt = images[0].reshape(-1, 3)[idx].contiguous()
    R = N_RAYS_TRAIN

    def nerf(dtype):
        cfg = Config(model="nerf", hidden=256, bf16=dtype == bf16).nerf_cfg()
        return NeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)

    models = {dtype: nerf(dtype) for dtype in (f32, bf16)}
    z_c = linspace_depths(64, 2.0, 6.0, dev).expand(R, 64).contiguous()
    with torch.no_grad():
        _, w = fused_nerf_render_rays_plain(models[f32].coarse, ro, rd, n_samples=64,
                                            return_weights=True)
    z_f = union_depths(w, 128, 2.0, 6.0)
    gen = torch.Generator(device=dev).manual_seed(5)
    noise_f = 0.5 * torch.randn(R, 192, generator=gen, device=dev)
    passes = {"coarse": (z_c, None, 32, True), "fine": (z_f, noise_f, 48, False)}

    def shard(name, b):
        """(z, deltas, noise) of shard b of the pass at world 2."""
        z, noise, _, _ = passes[name]
        sh = z.shape[1] // 2
        sl = slice(b * sh, (b + 1) * sh)
        return (z[:, sl].contiguous(), global_deltas(z, rd)[:, sl].contiguous(),
                None if noise is None else noise[:, sl].contiguous())

    def cotangents(S, seed, signed=True):
        """Random cotangents of C, A, T, D and the local weights (g_T and
        g_w nonzero): N(0, 1) / R, or with signed=False U[0.5, 1.5) / R."""
        g = torch.Generator(device=dev).manual_seed(seed)

        def draw(*shape):
            if signed:
                return torch.randn(*shape, generator=g, device=dev) / R
            return (0.5 + torch.rand(*shape, generator=g, device=dev)) / R

        cot = {k: draw(*shape) for k, shape in (("C", (R, 3)), ("A", (R,)), ("T", (R,)), ("D", (R,)))}
        return cot, draw(R, S)

    def inner(cot, g_w, partials, w):
        """sum of cotangent x output (the scalar whose gradient the
        backward computes) and the sum of its terms' magnitudes."""
        terms = [cot[k] * partials[k] for k in PARTIAL_KEYS] + ([g_w * w] if w is not None else [])
        return (float(sum(x.double().sum() for x in terms)),
                float(sum(x.double().abs().sum() for x in terms)))

    def relu_flips(mlp, mlp64, run):
        """Pre-activations (every layer's, the density's before its noise)
        on the other side of zero in run(mlp64) than in run(mlp), recorded
        by wrapping models/nerf.dense."""
        import tinynerf_tpu_torch.models.nerf as nerf_mod

        dense = nerf_mod.dense

        def signs(m):
            out = []

            def record(h, layer, dt):
                y = dense(h, layer, dt)
                out.append(y.detach() > 0)
                return y

            nerf_mod.dense = record
            try:
                with torch.no_grad():
                    run(m)
            finally:
                nerf_mod.dense = dense
            return out

        return sum(int((a != b).sum()) for a, b in zip(signs(mlp), signs(mlp64)))

    errs = {}
    for dtype in (f32, bf16):
        for name, mlp_of in (("coarse", lambda m: m.coarse), ("fine", lambda m: m.fine)):
            mlp = mlp_of(models[dtype])
            names = [n for n, _ in mlp.named_parameters()]
            _, _, sb, emit = passes[name]
            for b in (0, 1):
                what = f"K7 {name} shard {b} ({sb}-sample blocks) {str(dtype)[6:]}"
                z, deltas, noise = shard(name, b)
                S = z.shape[1]
                fn = make_fused_block_partials_fn(mlp.cfg, emit_weights=emit, sample_block=sb)
                plain_kw = dict(sample_block=sb, emit_weights=emit)

                def through_kernel(cot, g_w):
                    """One K7 forward and backward; both on the tensor cores in
                    bf16 only."""
                    mma = (fwd.mma_launches, bwd.mma_launches)
                    partials, w = fn(mlp, ro, rd, z, deltas, noise)
                    outs = [partials[k] for k in PARTIAL_KEYS] + ([w] if emit else [])
                    cots = [cot[k] for k in PARTIAL_KEYS] + ([g_w] if emit else [])
                    grads = torch.autograd.grad(outs, list(mlp.parameters()), grad_outputs=cots)
                    torch.cuda.synchronize()
                    check((fwd.mma_launches - mma[0], bwd.mma_launches - mma[1])
                          == (int(dtype == bf16),) * 2,
                          f"{what}: the tensor-core walk in bf16, the CUDA cores in f32")
                    return ({k: v.detach() for k, v in partials.items()},
                            w.detach() if emit else None, grads)

                def reference(ref_mlp, cot, g_w):
                    """(the plain version's inner product, its gradients)."""
                    with torch.no_grad():
                        p, pw = block_partials_plain(ref_mlp, ro, rd, z, deltas, noise, **plain_kw)
                    grads = block_partials_grads_plain(ref_mlp, ro, rd, z, deltas, noise, cot, g_w,
                                                       sample_block=sb)
                    return inner(cot, g_w, p, pw)[0], [g.float() for g in grads]

                cot, g_w = cotangents(S, 7 + b)
                g_w = g_w if emit else None
                partials, w, grads = through_kernel(cot, g_w)
                with torch.no_grad():
                    want, want_w = block_partials_plain(mlp, ro, rd, z, deltas, noise, **plain_kw)
                fe = {k: ray_errors(partials[k].reshape(R, -1) / (6.0 if k == "D" else 1.0),
                                    want[k].reshape(R, -1) / (6.0 if k == "D" else 1.0),
                                    width=3 if k == "C" else 1) for k in PARTIAL_KEYS}
                if emit:
                    fe["w"] = ray_errors(w, want_w, width=S)
                fe_max = max(float((partials[k] - want[k]).abs().max()) for k in PARTIAL_KEYS)
                print(f"[kernel] {what} forward (D over 6): {json.dumps(fe)}", flush=True)
                check(all(bool(torch.isfinite(partials[k]).all()) for k in PARTIAL_KEYS)
                      and all(within(e, dtype) for e in fe.values()),
                      f"{what}: partials and weights within {GATES[dtype]}")
                check(all(bool(torch.isfinite(g).all()) for g in grads), f"{what}: grads finite")
                got_l, scale = inner(cot, g_w, partials, w)
                if dtype == bf16:
                    # The tensor-core walk. With random-sign cotangents a
                    # leaf's sum cancels, so its scale is ill-conditioned: a
                    # reading. The gates: one-signed cotangents.
                    want_l, ref = reference(mlp, cot, g_w)
                    signed = {"inner_rel": abs(got_l - want_l) / scale, **leaf_errors(grads, ref),
                              "mma_scale_err": mma_scale_error(names, grads, ref)}
                    print(f"[kernel] {what} backward, signed cotangents (the scale a reading): "
                          f"{json.dumps(signed)}", flush=True)
                    check(signed["inner_rel"] < 1e-3 and signed["min_cosine"] > 0.98,
                          f"{what} backward: inner product rel < 1e-3, per-leaf cosine > 0.98")
                    cot, g_w = cotangents(S, 17 + b, signed=False)
                    g_w = g_w if emit else None
                    partials, w, grads = through_kernel(cot, g_w)
                    got_l, scale = inner(cot, g_w, partials, w)
                    want_l, ref = reference(mlp, cot, g_w)
                    be = {"inner_rel": abs(got_l - want_l) / scale, **leaf_errors(grads, ref),
                          "mma_scale_err": mma_scale_error(names, grads, ref)}
                    print(f"[kernel] {what} backward, one-signed cotangents: {json.dumps(be)}",
                          flush=True)
                    check(be["inner_rel"] < 1e-3 and be["min_cosine"] > 0.98
                          and be["mma_scale_err"] < MMA_SCALE,
                          f"{what} backward: inner product rel < 1e-3, per-leaf cosine > 0.98, "
                          f"each tensor-core leaf's scale within {MMA_SCALE} of 1")
                    errs[name, b, dtype] = {"fwd_max_abs": fe_max, "bwd_max_abs": be["max_abs"],
                                            "signed_scale_err": signed["mma_scale_err"],
                                            "scale_err": be["mma_scale_err"]}
                    continue
                # f32. With cotangents of random sign, every leaf is a sum of
                # terms of both signs whose max grows only like sqrt(points):
                # one pre-activation on the other side of its ReLU in the
                # float64 evaluation moves a leaf by ~1/sqrt(points) of its
                # max, the same for the kernel and the f32 plain version. A
                # reading: both against float64 sums, the count of such ReLU
                # flips, and the kernel against the f32 plain version.
                mlp64 = copy.deepcopy(mlp).double()
                want_l, ref = reference(mlp64, cot, g_w)
                _, plain = reference(mlp, cot, g_w)
                top = [max(float(r.abs().max()), 1e-30) for r in ref]
                dev64 = {n: [float((g - r).abs().max()) / m, float((p - r).abs().max()) / m]
                         for n, g, p, r, m in zip(names, grads, plain, ref, top)}
                worst = sorted(dev64, key=lambda n: -dev64[n][0])[:3]
                signed = {"inner_rel": abs(got_l - want_l) / scale,
                          "vs_float64_kernel_and_f32_plain": {n: dev64[n] for n in worst},
                          "kernel_vs_f32_plain_max_rel_to_leaf": max(
                              float((g - p).abs().max()) / m for g, p, m in zip(grads, plain, top)),
                          "relu_flips": relu_flips(mlp, mlp64, lambda m: block_partials_plain(
                              m, ro, rd, z, deltas, noise, **plain_kw))}
                print(f"[kernel] {what} backward, signed cotangents (a reading): "
                      f"{json.dumps(signed)}", flush=True)
                # The gate: one-signed random cotangents, against float64 sums
                # with the NeRF pass gates' capped allowance.
                cot, g_w = cotangents(S, 17 + b, signed=False)
                g_w = g_w if emit else None
                partials, w, grads = through_kernel(cot, g_w)
                got_l, scale = inner(cot, g_w, partials, w)
                want_l, ref = reference(mlp64, cot, g_w)
                _, plain = reference(mlp, cot, g_w)
                top = [max(float(r.abs().max()), 1e-30) for r in ref]
                gap = [float((g - r).abs().max()) for g, r in zip(grads, ref)]
                slack = [float((p - r).abs().max()) for p, r in zip(plain, ref)]
                be = {"inner_rel": abs(got_l - want_l) / scale, **leaf_errors(grads, ref),
                      "f32_plain_max_rel_to_leaf": max(sl / m for sl, m in zip(slack, top)),
                      "on_allowance": {n: [e / m, sl / m] for n, e, m, sl in
                                       zip(names, gap, top, slack) if e > 3e-4 * m}}
                print(f"[kernel] {what} backward, one-signed cotangents: {json.dumps(be)}",
                      flush=True)
                check(be["inner_rel"] < 1e-5 and all(e <= 3e-4 * m + min(sl, 3e-4 * m)
                                                     for e, m, sl in zip(gap, top, slack)),
                      f"{what} backward: inner product rel < 1e-5; per leaf |err| <= 3e-4 "
                      "max|leaf| + the f32 plain version's own |err| (capped at as much), "
                      "against float64 sums")
                errs[name, b, dtype] = {"fwd_max_abs": fe_max, "bwd_max_abs": be["max_abs"]}
    # Cross-checks, f32: two shards combined against the whole union's
    # K3 composite, and the MSE's gradient through them against K6's (and
    # both against float64 sums). At the shard boundary the density
    # recurrence starts from the cotangent of T, D = g_T - g_w: two terms
    # of size g_w that cancel where the colour changes little (PERF.md,
    # section 6), so the sigma head's two leaves are held to the JAX package's
    # K7 tolerance, 3e-4 of the leaf's max; every other leaf to K6-vs-K4's
    # 1e-5.
    m = models[f32]
    sigma_head = [n.startswith("sigma.") for n, _ in m.fine.named_parameters()]

    def boundary_gate(rel_to_leaf):
        return all(e <= (3e-4 if sig else 1e-5) for e, sig in zip(rel_to_leaf, sigma_head))

    cross = {}
    for name, mlp, z, sb in (("coarse", m.coarse, z_c, 32), ("fine", m.fine, z_f, 48)):
        fn = make_fused_block_partials_fn(m.cfg, sample_block=sb)
        parts = [fn(mlp, ro, rd, *shard(name, b)[:2])[0] for b in (0, 1)]
        comp, _, _ = combine_block_partials({k: torch.stack([p[k] for p in parts])
                                             for k in PARTIAL_KEYS})
        with torch.no_grad():
            k3 = fused_nerf_render_rays(mlp, ro, rd, z, cfg=m.cfg)
        cross[f"{name}_vs_k3"] = float((comp.detach() - k3).abs().max())
        if name == "fine":
            loss = torch.mean((comp - tgt) ** 2)
            grads = torch.autograd.grad(loss, list(mlp.parameters()))
            l6, g6 = fused_nerf_pass_grads_streamed(mlp, ro, rd, tgt, z, sample_block=64)
            g64 = [g.float() for g in fused_nerf_pass_grads_streamed_plain(
                copy.deepcopy(mlp).double(), ro, rd, tgt, z, sample_block=64)[1]]
            names = [n for n, _ in mlp.named_parameters()]

            def per_leaf(a, b):
                return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]

            k7_vs_k6 = per_leaf(grads, g6)
            cross["loss_rel_vs_k6"] = abs(float(loss) - float(l6)) / float(l6)
            cross["max_rel_to_leaf_vs_k6"] = dict(zip(names, k7_vs_k6))
            for what, g in (("k7", grads), ("k6", g6)):
                cross[f"{what}_vs_float64_worst"] = max(zip(per_leaf(g, g64), names))
    print(f"[kernel] K7 two shards vs the whole union, f32: {json.dumps(cross)}", flush=True)
    check(cross["coarse_vs_k3"] < 2.5e-5 and cross["fine_vs_k3"] < 2.5e-5,
          "two K7 shards combined equal K3's composite of the union within 2.5e-5")
    check(cross["loss_rel_vs_k6"] <= 1e-6 and boundary_gate(k7_vs_k6),
          "MSE gradient through two K7 shards equals K6's: loss rel <= 1e-6, per leaf <= 1e-5 "
          "max|leaf| (the sigma head's <= 3e-4)")
    mlp = models[bf16].fine
    fn = make_fused_block_partials_fn(mlp.cfg, emit_weights=True, sample_block=48)
    cot, g_w = cotangents(96, 9)
    runs = []
    mma = (fwd.mma_launches, bwd.mma_launches)
    for _ in range(2):
        partials, w = fn(mlp, ro, rd, *shard("fine", 1))
        outs = [partials[k] for k in PARTIAL_KEYS] + [w]
        grads = torch.autograd.grad(outs, list(mlp.parameters()),
                                    grad_outputs=[cot[k] for k in PARTIAL_KEYS] + [g_w])
        runs.append([o.detach().clone() for o in outs] + [g.clone() for g in grads])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[kernel] K7 bf16 (tensor cores) same inputs twice: bit-identical {same}", flush=True)
    check(same and (fwd.mma_launches - mma[0], bwd.mma_launches - mma[1]) == (2, 2),
          "K7 forward and backward on the tensor cores, bit-identical on the same inputs")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 24. train. (a) world 1 in process: one flagship step of the sharded
    #     block, K7 against the eager shard, on the same draws.
    t0 = time.time()
    settings = Config(model="nerf", hidden=256, n_fine=128).train_settings()
    train_poses = poses[: n_images - 4]
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, train_poses)
    pixels = images[: n_images - 4].reshape(len(train_poses), H * W, 3)
    step = {}
    for fused in (True, False):
        model = nerf(bf16)
        opt = make_optimizer(model.parameters(), settings.lr)
        block = make_sharded_train_block(settings, 1, make_mesh(), nerf_cfg=model.cfg, n_fine=128,
                                         fused_kernels=fused)
        fwd.launches = fwd.mma_launches = bwd.launches = bwd.mma_launches = 0
        metrics = block(model, opt, 0, 0, rays_o_all, rays_d_all, pixels)
        step[fused] = (float(metrics["loss"][0] + metrics["loss_coarse"][0]),
                       [p.grad.clone() for p in model.parameters()],
                       (fwd.launches, fwd.mma_launches, bwd.launches, bwd.mma_launches))
    a_err = {"loss_rel": abs(step[True][0] - step[False][0]) / step[False][0],
             "launches": step[True][2], **leaf_errors(step[True][1], step[False][1]),
             "mma_scale_err": mma_scale_error([n for n, _ in model.named_parameters()],
                                              step[True][1], step[False][1])}
    print(f"[train] (a) world-1 sharded step, K7 vs the eager shard, bf16: {json.dumps(a_err)}",
          flush=True)
    check(step[True][2] == (2, 2, 2, 2) and step[False][2] == (0, 0, 0, 0),
          "the K7 step runs 2 forwards and 2 backwards, all on the tensor cores; the eager step "
          "none")
    check(a_err["loss_rel"] < 1e-3 and a_err["min_cosine"] > 0.98
          and a_err["mma_scale_err"] < MMA_SCALE,
          "K7 step vs eager step: loss rel < 1e-3, per-leaf cosine > 0.98, each trunk and rgb_in "
          f"leaf's scale within {MMA_SCALE} of 1")

    # (b) two ranks on the one card through the trainer: the main path.
    sp_metrics = os.path.join(OUT_DIR, "sp2.jsonl")
    if os.path.exists(sp_metrics):
        os.unlink(sp_metrics)
    sp = torchrun_train("sp2", "--sample-parallel", "2", "--iters", str(SP_ITERS), "--no-resume",
                        "--metrics-path", sp_metrics)
    k7_names = ("fused_block_partials_fwd", "fused_block_partials_fwd.mma_launches",
                "fused_block_partials_bwd", "fused_block_partials_bwd.mma_launches")
    main_launches = [tuple(r.get(k, 0) for k in k7_names) for r in sp["launches"]]
    losses = [r["loss"] for r in map(json.loads, open(sp_metrics)) if "loss" in r]
    print(f"[train] (b) sample-parallel 2 ranks, {SP_ITERS} steps: K7 (forward, on the tensor "
          f"cores, backward, on the tensor cores) launches per rank {main_launches}, losses "
          f"{losses}", flush=True)
    check(all(x == (2 * SP_ITERS,) * 4 for x in main_launches),
          "each rank's K7 ran 2 forwards and 2 backwards per step, all on the tensor cores")
    check(all(math.isfinite(x) for x in losses), "sample-parallel losses finite")
    check("[distributed] process 0/2, backend gloo" in sp["out"],
          "two ranks sharing the card take gloo")
    resumed = torchrun_train("sp2", "--sample-parallel", "2", "--iters", str(SP_ITERS + 5))
    check(f"from step {SP_ITERS}" in resumed["out"], f"resume prints from step {SP_ITERS}")
    dp = torchrun_train("dp2", "--iters", str(DP_ITERS), "--no-resume")
    k46_names = ("fused_nerf_pass_grads", "fused_nerf_pass_grads.mma_launches",
                 "fused_nerf_pass_grads_streamed", "fused_nerf_pass_grads_streamed.mma_launches")
    dp_launches = [tuple(r.get(k, 0) for k in k46_names) for r in dp["launches"]]
    print(f"[train] (b) data-parallel 2 ranks, {DP_ITERS} steps: (K4, on the tensor cores, K6, on "
          f"the tensor cores) launches per rank {dp_launches}", flush=True)
    check(all(x == (DP_ITERS,) * 4 for x in dp_launches),
          "data-parallel: K4 and K6 once per step on each rank, on the tensor cores")

    # (c) one sharded pass on the same z, world 2 (spawned ranks) against
    #     world 1 (in process): the gates of phase 23's cross-checks.
    inputs = {"ro": ro.cpu(), "rd": rd.cpu(), "tgt": tgt.cpu(), "z_c": z_c.cpu(), "z_f": z_f.cpu()}
    path = os.path.abspath(os.path.join(OUT_DIR, "sharded_pass.pt"))
    store = path + ".store"
    torch.save(inputs, path)
    if os.path.exists(store):
        os.unlink(store)
    mp.spawn(sharded_pass_rank, args=(2, f"file://{store}", path), nprocs=2, join=True)
    one = sharded_pass_case(make_mesh(), inputs, dev)
    c_err, c_leaf = {}, {}
    names = [n for n, _ in models[f32].fine.named_parameters()]
    for r in (0, 1):
        two = torch.load(f"{path}.rank{r}")
        c_leaf[r] = [float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(two["grads"], one["grads"])]
        c_err[r] = {k: float((two[k] - one[k]).abs().max()) for k in ("comp_c", "w_c", "comp_f")}
        c_err[r].update(loss_rel=abs(two["loss"] - one["loss"]) / one["loss"],
                        max_rel_to_leaf=max(zip(c_leaf[r], names)))
    print(f"[train] (c) sharded pass, world 2 vs world 1, f32, per rank: {json.dumps(c_err)}",
          flush=True)
    check(all(e["comp_c"] < 2.5e-5 and e["w_c"] < 2.5e-5 and e["comp_f"] < 2.5e-5
              and e["loss_rel"] <= 1e-6 and boundary_gate(c_leaf[r]) for r, e in c_err.items()),
          "world 2 equals world 1: composites and weights within 2.5e-5, loss rel <= 1e-6, "
          "per leaf <= 1e-5 max|leaf| (the sigma head's <= 3e-4, phase 23's boundary gate)")
    print(f"[train] ok in {time.time() - t0:.2f}s", flush=True)

    # 25. timing: plain, kernel, kernel, plain (bf16, flagship)
    t0 = time.time()
    m = models[bf16]
    cases = {}
    for name, mlp, b in (("fine", m.fine, 1), ("coarse", m.coarse, 0)):
        _, _, sb, emit = passes[name]
        z, deltas, noise = shard(name, b)
        tile = 128 // math.gcd(128, sb)
        fn = make_fused_block_partials_fn(m.cfg, emit_weights=emit, sample_block=sb)
        cot, g_w = cotangents(z.shape[1], 11)
        g_w = g_w if emit else None
        g_ray = torch.cat([cot["C"], torch.stack([cot["A"], cot["T"], cot["D"]], dim=1)], dim=1)
        _, tin, _, w_fwd, w_mma = fwd(mlp, m.cfg, ro, rd, z, deltas, noise, sb, tile, emit)
        args = (ro, rd, z, deltas, noise)
        cases[name, "fwd"] = {
            "kernel": lambda fn=fn, mlp=mlp, args=args: fn(mlp, *args),
            "plain": lambda mlp=mlp, args=args, sb=sb, emit=emit: block_partials_plain(
                mlp, *args, sample_block=sb, emit_weights=emit)}
        cases[name, "bwd"] = {
            "kernel": lambda mlp=mlp, args=args, tin=tin, g_ray=g_ray, g_w=g_w, w_fwd=w_fwd,
            w_mma=w_mma, sb=sb, tile=tile: bwd(mlp, m.cfg, *args, tin, g_ray, g_w, w_fwd, w_mma,
                                               sb, tile),
            "plain": lambda mlp=mlp, args=args, cot=cot, g_w=g_w, sb=sb: block_partials_grads_plain(
                mlp, *args, cot, g_w, sample_block=sb)}
    counter = iter(range(10**6))
    for fused in (True, False):
        step_model = nerf(bf16)
        step_opt = make_optimizer(step_model.parameters(), settings.lr)
        block = make_sharded_train_block(settings, 1, make_mesh(), nerf_cfg=step_model.cfg,
                                         n_fine=128, fused_kernels=fused)
        cases.setdefault(("step", ""), {})["kernel" if fused else "plain"] = (
            lambda block=block, sm=step_model, so=step_opt: block(
                sm, so, 0, next(counter), rays_o_all, rays_d_all, pixels))
    times = {}
    with torch.no_grad():
        for key, fns in cases.items():
            for name in ("plain", "kernel", "kernel", "plain"):
                if key[0] == "step":
                    with torch.enable_grad():
                        t = cuda_ms(fns[name], iters=3)
                else:
                    t = cuda_ms(fns[name], iters=5)
                times.setdefault((*key, name), []).append(t)
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: bf16 (tensor cores), {R} rays; K7 forward fine shard (S=96, block 48) "
          f"{ms['fine', 'fwd', 'kernel']:.4f} ms, plain {ms['fine', 'fwd', 'plain']:.4f} ms; "
          f"coarse shard (S=32, weights) {ms['coarse', 'fwd', 'kernel']:.4f} ms, plain "
          f"{ms['coarse', 'fwd', 'plain']:.4f} ms; K7 backward fine shard "
          f"{ms['fine', 'bwd', 'kernel']:.4f} ms, plain {ms['fine', 'bwd', 'plain']:.4f} ms; "
          f"coarse shard {ms['coarse', 'bwd', 'kernel']:.4f} ms, plain "
          f"{ms['coarse', 'bwd', 'plain']:.4f} ms; world-1 sharded step K7 "
          f"{ms['step', '', 'kernel']:.4f} ms, eager {ms['step', '', 'plain']:.4f} ms "
          f"(all runs {json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    print(f"[timing] {card}: flagship train loop of two processes sharing one card (not "
          f"scaling): sample-parallel 2 {sp['rays_per_sec'] / R:.2f} steps/s "
          f"({sp['rays_per_sec']:,.0f} rays/s), data-parallel 2 {dp['rays_per_sec'] / R:.2f} "
          f"steps/s ({dp['rays_per_sec']:,.0f} rays/s)", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    mlp_par = sum(p.numel() for p in m.fine.parameters())
    S, nb = 96, 2  # the fine shard at world 2, blocks of 48
    macs, train_macs = macs_per_point(m.fine), train_macs_per_point(m.fine)
    replaces = "tinynerf_tpu/kernels/fused_partials.py"
    return [
        kernel_entry(
            "fused_block_partials (forward)", "tinynerf_tpu_torch/csrc/fused_partials.cu",
            f"{replaces}:407", sum(x[0] for x in main_launches),
            errs["fine", 1, bf16]["fwd_max_abs"], ms["fine", "fwd", "kernel"],
            ms["fine", "fwd", "plain"], flops=2 * R * S * macs,
            # rays, z, deltas, noise and the weights in; partials, entry T out
            nbytes=4 * (R * (6 + 3 * S) + mlp_par + R * (6 + nb))),
        kernel_entry(
            "fused_block_partials (backward)", "tinynerf_tpu_torch/csrc/fused_partials.cu",
            f"{replaces}:486", sum(x[1] for x in main_launches),
            errs["fine", 1, bf16]["bwd_max_abs"], ms["fine", "bwd", "kernel"],
            ms["fine", "bwd", "plain"], flops=2 * R * S * (train_macs - macs),
            # rays, z, deltas, noise, entry T, cotangents and the weights in;
            # gradients out (the recomputed forward is not counted)
            nbytes=4 * (R * (6 + 3 * S + nb + 6) + 2 * mlp_par)),
    ]


LEVER_ITERS = 200  # phase 27 (a): the flagship with every lever on, then a resume to +50
LEVER_FLAGS = dict(ray_sampling="pool", precrop_iters=50, sigma_noise_std=1.0,
                   sigma_noise_decay_steps=100, sigma_noise_floor=0.1, lr_decay_steps=200,
                   lr_floor=5e-5, weight_decay=1e-4, ema_decay=0.99, sigma_sparsity=1e-3)
LEVER_SP_ITERS = 10  # phase 28: the 2-rank sample-parallel run with the prior and the EMA


def run_levers(build_nerf_train, build_partials) -> None:
    """Phases 26-28: the route of bf16 K4, K6 and K7 off the tensor cores'
    widths, the training levers at full width, and the sharded levers."""
    import dataclasses

    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_nerf import fused_nerf_render_rays
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed, fused_nerf_pass_grads_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads, fused_nerf_pass_grads_plain, make_fused_nerf_grad_fn,
        uses_tensor_cores,
    )
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain, block_partials_plain, fused_block_partials_bwd,
        fused_block_partials_fwd, make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFMLP
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays
    from tinynerf_tpu_torch.ops.rays import get_rays, get_rays_for_poses
    from tinynerf_tpu_torch.ops.regularizers import make_sparsity_grad_fn
    from tinynerf_tpu_torch.ops.volume import global_deltas
    from tinynerf_tpu_torch.training import make_train_step, settings_optimizer

    dev = torch.device("cuda", 0)
    card = card_line()
    k4, k6 = fused_nerf_pass_grads, fused_nerf_pass_grads_streamed
    fwd, bwd = fused_block_partials_fwd, fused_block_partials_bwd
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    rays_o, rays_d = get_rays(H, W, focal, poses[0])
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:N_RAYS_TRAIN].to(dev)
    ro, rd = rays_o[idx].contiguous(), rays_d[idx].contiguous()
    tgt = images[0].reshape(-1, 3)[idx].contiguous()
    R = N_RAYS_TRAIN

    # 26. route (F1): bf16 K4, K6 and K7 at widths off the tensor cores'
    #     layout take the CUDA-core walk, by configuration.
    t0 = time.time()
    for build, what in ((build_nerf_train, "K4/K6"), (build_partials, "K7")):
        hmma = sass_counts(build.result()[0], "HMMA")
        cuda_core = [n for mma, _, n in walk_hmma(hmma) if not mma]
        print(f"[route] {what}: HMMA in the CUDA-core walks (kMma=false, one-round and general) "
              f"{cuda_core}", flush=True)
        check(cuda_core and not any(cuda_core),
              f"the {what} CUDA-core walks that off-layout bf16 launches run hold no HMMA")
    g = torch.Generator(device=dev).manual_seed(26)
    z_union = torch.sort(2.0 + 4.0 * torch.rand(R, 192, generator=g, device=dev), dim=1).values
    deltas = global_deltas(z_union, rd)
    z_sh, d_sh = z_union[:, 96:].contiguous(), deltas[:, 96:].contiguous()
    cot = {k: (0.5 + torch.rand(*shape, generator=g, device=dev)) / R
           for k, shape in (("C", (R, 3)), ("A", (R,)), ("T", (R,)), ("D", (R,)))}
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    route = {}
    for hidden, rgb_hidden in ((48, 24), (256, 32)):
        cfg = Config(model="nerf", hidden=hidden, rgb_hidden=rgb_hidden).nerf_cfg()
        check(cfg.compute_dtype == torch.bfloat16 and not uses_tensor_cores(cfg),
              f"bf16 hidden {hidden} rgb_hidden {rgb_hidden} routes off the tensor cores")
        mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        names = [n for n, _ in mlp.named_parameters()]
        before = [(k.launches, k.mma_launches) for k in (k4, k6, fwd, bwd)]
        loss, grads, _, z = k4(mlp, ro, rd, tgt, seed, n_samples=64, emit_sampling=True, cfg=cfg)
        want = fused_nerf_pass_grads_plain(mlp, ro, rd, tgt, 0, z, randomized=False, cfg=cfg)
        loss6, grads6 = k6(mlp, ro, rd, tgt, z_union, cfg=cfg, sample_block=64)
        want6 = fused_nerf_pass_grads_streamed_plain(mlp, ro, rd, tgt, z_union, cfg=cfg,
                                                     sample_block=64)
        fn = make_fused_block_partials_fn(cfg, sample_block=48)
        partials, _ = fn(mlp, ro, rd, z_sh, d_sh)
        outs = [partials[k] for k in ("C", "A", "T", "D")]
        grads7 = torch.autograd.grad(outs, list(mlp.parameters()),
                                     grad_outputs=[cot[k] for k in ("C", "A", "T", "D")])
        with torch.no_grad():
            want7, _ = block_partials_plain(mlp, ro, rd, z_sh, d_sh, None, cfg=cfg, sample_block=48)
        wgrads7 = block_partials_grads_plain(mlp, ro, rd, z_sh, d_sh, None, cot, None, cfg=cfg,
                                             sample_block=48)
        torch.cuda.synchronize()
        moved = [(k.launches - a, k.mma_launches - b)
                 for k, (a, b) in zip((k4, k6, fwd, bwd), before)]
        errs = {}
        for name, l, gr, (wl, wg) in (("K4", loss, grads, want), ("K6", loss6, grads6, want6)):
            errs[name] = {"loss_rel": abs(float(l) - float(wl)) / float(wl),
                          **leaf_errors(gr, wg), "mma_scale_err": mma_scale_error(names, gr, wg)}
        errs["K7 fwd"] = {k: ray_errors(partials[k].detach() / (6.0 if k == "D" else 1.0),
                                        want7[k] / (6.0 if k == "D" else 1.0),
                                        width=3 if k == "C" else 1) for k in ("C", "A", "T", "D")}
        errs["K7 bwd"] = {**leaf_errors(grads7, wgrads7),
                          "mma_scale_err": mma_scale_error(names, grads7, wgrads7)}
        route[hidden, rgb_hidden] = {"launches_and_tensor_core_launches": moved, **errs}
        print(f"[route] bf16 hidden {hidden} rgb_hidden {rgb_hidden}, {R} rays (K4 S=64, K6 "
              f"S=192 block 64, K7 a 96-sample shard block 48) against the plain versions: "
              f"{json.dumps(route[hidden, rgb_hidden])}", flush=True)
        check(moved == [(1, 0)] * 4,
              "K4, K6, K7 forward and backward launched once each, none on the tensor cores")
        for name in ("K4", "K6", "K7 bwd"):
            e = errs[name]
            check(e.get("loss_rel", 0.0) < 1e-3 and e["min_cosine"] > 0.98
                  and e["mma_scale_err"] < MMA_SCALE,
                  f"{name} at hidden {hidden}: loss rel < 1e-3, worst leaf cosine > 0.98, each "
                  f"trunk and rgb_in leaf's scale within {MMA_SCALE} of 1")
        check(all(within(e, torch.bfloat16) for e in errs["K7 fwd"].values()),
              f"K7 forward at hidden {hidden}: the partials within the bf16 render gates")
        if hidden != 48:
            continue
        # Timing at hidden 48 (CUDA-core walk, bf16), plain, kernel, kernel, plain.
        def k7_pair(fn):
            parts, _ = fn(mlp, ro, rd, z_sh, d_sh)
            torch.autograd.grad([parts[k] for k in ("C", "A", "T", "D")],
                                list(mlp.parameters()),
                                grad_outputs=[cot[k] for k in ("C", "A", "T", "D")])

        def k7_plain():
            block_partials_plain(mlp, ro, rd, z_sh, d_sh, None, cfg=cfg, sample_block=48)
            block_partials_grads_plain(mlp, ro, rd, z_sh, d_sh, None, cot, None, cfg=cfg,
                                       sample_block=48)

        cases = {
            "K4": {"kernel": lambda: k4(mlp, ro, rd, tgt, seed, n_samples=64, emit_sampling=True,
                                        cfg=cfg),
                   "plain": lambda: fused_nerf_pass_grads_plain(mlp, ro, rd, tgt, 3, n_samples=64,
                                                                emit_sampling=True, cfg=cfg)},
            "K6": {"kernel": lambda: k6(mlp, ro, rd, tgt, z_union, cfg=cfg, sample_block=64),
                   "plain": lambda: fused_nerf_pass_grads_streamed_plain(
                       mlp, ro, rd, tgt, z_union, cfg=cfg, sample_block=64)},
            "K7 pair": {"kernel": lambda: k7_pair(fn), "plain": k7_plain},
        }
        times = {}
        for what, fns in cases.items():
            for name in ("plain", "kernel", "kernel", "plain"):
                times.setdefault((what, name), []).append(cuda_ms(fns[name], iters=5))
        ms48 = {k: min(v) for k, v in times.items()}
        print(f"[timing] {card}: bf16 at hidden 48, rgb_hidden 24, on the CUDA-core walk, {R} "
              f"rays: K4 (S=64, weights and z out) {ms48['K4', 'kernel']:.4f} ms, plain "
              f"{ms48['K4', 'plain']:.4f}; K6 (S=192, block 64) {ms48['K6', 'kernel']:.4f}, plain "
              f"{ms48['K6', 'plain']:.4f}; K7 forward + backward (S=96, block 48) "
              f"{ms48['K7 pair', 'kernel']:.4f}, plain {ms48['K7 pair', 'plain']:.4f} (all runs "
              f"{json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    h48 = Config(model="nerf", hidden=48, rgb_hidden=24, n_fine=64, iters=50, log_every=10,
                 data_path=data_path, resume=False, out_dir=os.path.join(OUT_DIR, "nerf48"),
                 ckpt_path=os.path.join(OUT_DIR, "nerf48.npz"),
                 metrics_path=os.path.join(OUT_DIR, "nerf48.jsonl"))
    if os.path.exists(h48.metrics_path):
        os.unlink(h48.metrics_path)
    k4.launches = k4.mma_launches = k6.launches = k6.mma_launches = 0
    train_mod.main(h48)
    h48_launches = (k4.launches, k4.mma_launches, k6.launches, k6.mma_launches)
    losses = [r["loss"] for r in map(json.loads, open(h48.metrics_path)) if "loss" in r]
    print(f"[route] train --model nerf --hidden 48 --rgb-hidden 24 --n-fine 64, bf16 fused, 50 "
          f"steps: (K4, on the tensor cores, K6, on the tensor cores) launches {h48_launches}, "
          f"losses {losses}", flush=True)
    check(h48_launches == (100, 0, 0, 0) and all(math.isfinite(x) for x in losses),
          "hidden 48 trains fused: K4 twice a step, none on the tensor cores; losses finite")
    print(f"[route] ok in {time.time() - t0:.2f}s", flush=True)

    # 27. levers at full width. (a) the flagship with every lever on, then a
    #     resume; the EMA twin served by eval on the strided poses.
    t0 = time.time()
    flag = Config(model="nerf", hidden=256, n_fine=128, data_path=data_path, iters=LEVER_ITERS,
                  holdout=4, holdout_mode="strided", eval_every=100, ckpt_keep=2, log_every=10,
                  resume=False, out_dir=os.path.join(OUT_DIR, "levers"),
                  ckpt_path=os.path.join(OUT_DIR, "levers", "flagship.npz"),
                  metrics_path=os.path.join(OUT_DIR, "levers.jsonl"), **LEVER_FLAGS)
    if os.path.exists(flag.metrics_path):
        os.unlink(flag.metrics_path)
    os.makedirs(flag.out_dir, exist_ok=True)
    for f in os.listdir(flag.out_dir):
        if f.startswith("flagship.npz"):
            os.unlink(os.path.join(flag.out_dir, f))
    k4.launches = k4.mma_launches = k6.launches = k6.mma_launches = 0
    res = train_mod.main(flag)
    a_launches = (k4.launches, k4.mma_launches, k6.launches, k6.mma_launches)
    lr_200 = res["optimizer"].param_groups[0]["lr"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res2 = train_mod.main(dataclasses.replace(flag, iters=LEVER_ITERS + 50, resume=True))
    print(out.getvalue().strip(), flush=True)
    a_launches2 = (k4.launches, k4.mma_launches, k6.launches, k6.mma_launches)
    opt = res2["optimizer"]
    # optax.exponential_decay(5e-4, 200, 0.1, end_value=5e-5), by hand
    want_199 = max(5e-4 * 0.1 ** (199 / 200), 5e-5)
    want_250 = max(5e-4 * 0.1 ** (250 / 200), 5e-5)
    recs = [json.loads(line) for line in open(flag.metrics_path)]
    held = [(r["step"], r["eval"]["psnr_mean"], r["eval_ema"]["psnr_mean"])
            for r in recs if r.get("kind") == "held-out" and "eval_ema" in r]
    copies = sorted(f for f in os.listdir(flag.out_dir) if f.startswith("flagship.npz.step"))
    k3_before = fused_nerf_render_rays.launches
    ev = eval_mod.main(eval_mod.EvalConfig(ckpt_path=flag.ckpt_path, data_path=data_path,
                                           ema=True, holdout_views=True,
                                           out_dir=os.path.join(OUT_DIR, "eval_levers")))
    with open(os.path.join(OUT_DIR, "eval_levers", "metrics.json")) as f:
        ev_indices = json.load(f)["indices"]
    strided = train_mod.strided_holdout(n_images, 4)
    print(f"[levers] (a) flagship, every lever on ({json.dumps(LEVER_FLAGS)}, strided holdout 4, "
          f"eval every 100, ckpt-keep 2), {LEVER_ITERS} steps then a resume to "
          f"{LEVER_ITERS + 50}: (K4, on the tensor cores, K6, on the tensor cores) launches "
          f"{a_launches} then {a_launches2}; lr of the last step {lr_200!r} (want {want_199!r}), "
          f"after the resume count {opt.count()} lr {opt.lr_at(opt.count())!r} (want "
          f"{want_250!r}); held-out (step, raw, EMA) {held}; rotated copies {copies}; eval --ema "
          f"--holdout-views on poses {ev_indices} (strided {strided}): PSNR "
          f"{ev['psnr_mean']:.3f} dB, K3 launches {fused_nerf_render_rays.launches - k3_before}",
          flush=True)
    check(a_launches == (LEVER_ITERS,) * 4 and a_launches2 == (LEVER_ITERS + 50,) * 4,
          "every K4 and K6 launch of the lever run and its resume on the tensor cores")
    check(abs(lr_200 - want_199) <= 1e-12 and opt.count() == LEVER_ITERS + 50
          and abs(opt.lr_at(opt.count()) - want_250) <= 1e-12
          and f"from step {LEVER_ITERS}" in out.getvalue(),
          "the lr follows the schedule at the optimizer's count, across the resume")
    check(os.path.exists(flag.ckpt_path + ".ema.npz") and ev_indices == strided
          and math.isfinite(ev["psnr_mean"]) and fused_nerf_render_rays.launches > k3_before,
          "the EMA twin exists and eval --ema --holdout-views serves it on the strided poses")
    check(copies == [f"flagship.npz.step{s:08d}.npz" for s in (LEVER_ITERS, LEVER_ITERS + 50)],
          "exactly two rotated checkpoint copies")
    check([h[0] for h in held] == [100, 200, 250]
          and all(math.isfinite(x) for h in held for x in h[1:]),
          "held-out JSONL records with eval_ema at steps 100, 200 and 250")

    # (b) the TinyNeRF through K2: pool, precrop, noise decay and the EMA.
    tiny = Config(data_path=data_path, iters=TRAIN_ITERS, holdout=4, resume=False,
                  ray_sampling="pool", precrop_iters=200, sigma_noise_std=1.0,
                  sigma_noise_decay_steps=500, ema_decay=0.999,
                  out_dir=os.path.join(OUT_DIR, "levers_tiny"),
                  ckpt_path=os.path.join(OUT_DIR, "levers_tiny.npz"),
                  metrics_path=os.path.join(OUT_DIR, "levers_tiny.jsonl"))
    if os.path.exists(tiny.metrics_path):
        os.unlink(tiny.metrics_path)
    fused_loss_grads.launches = fused_loss_grads.mma_launches = 0
    res_tiny = train_mod.main(tiny)
    psnrs = logged_psnrs(tiny.metrics_path)
    k2 = (fused_loss_grads.launches, fused_loss_grads.mma_launches)
    print(f"[levers] (b) TinyNeRF, pool + precrop 200 + noise decay 500 + EMA 0.999, "
          f"{TRAIN_ITERS} steps: K2 (launches, on the tensor cores) {k2}, train PSNR "
          f"{psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, held-out {res_tiny['eval']['psnr_mean']:.2f} dB, "
          f"EMA {res_tiny['eval_ema']['psnr_mean']:.2f} dB", flush=True)
    check(k2 == (TRAIN_ITERS, TRAIN_ITERS) and psnrs[-1] - psnrs[0] >= 3.0,
          "the TinyNeRF lever run goes through K2 on the tensor cores and its PSNR rises >= 3 dB")

    # (c) the watchdog, in a subprocess: a margin of 100 dB pins every
    #     logged PSNR, so the run saves, logs and exits 3.
    dead = os.path.join(OUT_DIR, "dead")
    dead_metrics = dead + ".jsonl"
    if os.path.exists(dead_metrics):
        os.unlink(dead_metrics)
    proc = subprocess.run(
        [sys.executable, "-m", "tinynerf_tpu_torch.train", "--data-path", data_path, "--iters",
         "50", "--log-every", "1", "--death-grace", "0", "--death-window", "2",
         "--death-margin", "100", "--no-resume", "--out-dir", dead, "--ckpt-path",
         dead + ".npz", "--metrics-path", dead_metrics],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": os.getcwd()})
    death = [r for r in map(json.loads, open(dead_metrics)) if r.get("sigma_death")]
    print(f"[levers] (c) watchdog run: rc {proc.returncode}, record {death}, "
          f"{[x for x in proc.stdout.splitlines() if 'SIGMA' in x or 'watchdog' in x]}", flush=True)
    check(proc.returncode == 3 and len(death) == 1 and death[0]["step"] == 2
          and os.path.exists(dead + ".npz"),
          "a background-pinned run exits 3 after writing its checkpoint and its sigma_death record")

    # (d) timing, plain, levers, levers, plain: one flagship step (fused)
    #     with every lever on against the plain recipe's, and the prior's
    #     and the EMA update's time alone.
    plain_s = Config(model="nerf", hidden=256, n_fine=128).train_settings()
    lever_s = dataclasses.replace(
        Config(model="nerf", hidden=256, n_fine=128, **LEVER_FLAGS).train_settings(),
        image_hw=(H, W))
    train_poses = poses[: n_images - 4]
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, train_poses)
    pixels = images[: n_images - 4].reshape(len(train_poses), H * W, 3)
    ncfg = Config(model="nerf", hidden=256).nerf_cfg()
    prior = make_sparsity_grad_fn(lever_s, "nerf", nerf_cfg=ncfg, lam=1e-3,
                                  aabb=aabb_from_rays(rays_o_all, rays_d_all, 2.0, 6.0))
    states, fns = {}, {}
    for name, s, extra in (("plain", plain_s, None), ("levers", lever_s, prior)):
        model = NeRF(ncfg, generator=torch.Generator().manual_seed(0), device=dev)
        states[name] = (model, settings_optimizer(model.parameters(), s))
        fns[name] = make_train_step(s, grad_fn=make_fused_nerf_grad_fn(s, ncfg, n_fine=128),
                                    extra_grad_fn=extra)
    counter = iter(range(1000, 10**6))  # past the precrop warmup
    cases = {name: (lambda n=name: fns[n](*states[n], 0, next(counter), rays_o_all, rays_d_all,
                                          pixels)) for name in fns}
    model, opt = states["levers"]
    gen = torch.Generator(device=dev).manual_seed(0)
    cases["prior"] = lambda: prior(model, gen)

    def ema_update():
        torch._foreach_mul_(opt.ema, opt.ema_decay)
        torch._foreach_add_(opt.ema, opt.params, alpha=1.0 - opt.ema_decay)

    cases["ema"] = ema_update
    times = {}
    for name in ("plain", "levers", "levers", "plain", "prior", "ema", "ema", "prior"):
        times.setdefault(name, []).append(cuda_ms(cases[name], iters=5))
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: flagship train step (fused, K4 + K6, 2048 rays), every lever on "
          f"{ms['levers']:.4f} ms against the plain recipe's {ms['plain']:.4f} ms; the sparsity "
          f"prior alone (8192 points, both MLPs, eager autograd) {ms['prior']:.4f} ms; the EMA "
          f"update alone {ms['ema']:.4f} ms (all runs {json.dumps(times)})", flush=True)
    print(f"[levers] ok in {time.time() - t0:.2f}s", flush=True)

    # 28. sharded levers: two ranks on the one card, sample-parallel 2 (K7),
    #     the prior, the EMA and the lr schedule.
    t0 = time.time()
    sp_metrics = os.path.join(OUT_DIR, "levers_sp2.jsonl")
    if os.path.exists(sp_metrics):
        os.unlink(sp_metrics)
    sp = torchrun_train("levers_sp2", "--sample-parallel", "2", "--iters", str(LEVER_SP_ITERS),
                        "--no-resume", "--sigma-sparsity", "1e-3", "--ema-decay", "0.99",
                        "--lr-decay-steps", "20", "--metrics-path", sp_metrics)
    ema_digests = {line.split("EMA digest ")[1].split(",")[0] for line in sp["out"].splitlines()
                   if "EMA digest" in line}
    k7_names = ("fused_block_partials_fwd", "fused_block_partials_fwd.mma_launches",
                "fused_block_partials_bwd", "fused_block_partials_bwd.mma_launches")
    sp_launches = [tuple(r.get(k, 0) for k in k7_names) for r in sp["launches"]]
    losses = [r["loss"] for r in map(json.loads, open(sp_metrics)) if "loss" in r]
    print(f"[levers] sample-parallel 2 ranks with the prior, the EMA and the lr schedule, "
          f"{LEVER_SP_ITERS} steps: K7 launches per rank {sp_launches}, EMA digests "
          f"{sorted(ema_digests)}, losses {losses}", flush=True)
    check(len(ema_digests) == 1 and sp["out"].count("EMA digest") == 2,
          "both ranks' EMA bit-identical (their parameters too: torchrun_train)")
    check(all(x == (2 * LEVER_SP_ITERS,) * 4 for x in sp_launches),
          "each rank's K7 ran 2 forwards and 2 backwards per step, all on the tensor cores")
    check(all(math.isfinite(x) for x in losses), "sharded lever losses finite")
    print(f"[levers] ok in {time.time() - t0:.2f}s", flush=True)


F3_WIDTHS = ((48, 64), (36, 20))  # phase 29: F3's example and a width pair off multiples of 8
F3_TRAIN_ITERS = 50  # phase 29: train --model nerf --hidden 48 (the default rgb_hidden 64)
NDC_FLAGSHIP_ITERS = 20  # phase 30: the flagship under --ndc, then a resume to +5
OCC_ITERS = 200  # phase 32: the flagship occupancy run, then a resume to +50
OCC_SHORT_ITERS = 20  # phase 33: --proposal occupancy --ndc
OCC_DP_ITERS = 10  # phase 33: the 2-rank data-parallel occupancy run
NDC_SP_ITERS = 5  # phase 33: the 2-rank --ndc --sample-parallel 2 run (K7)


def forward_facing_data(dev) -> str:
    """The --ndc scene: synthetic.generate_synthetic_dataset(forward_facing=
    True), 106 forward-facing poses of 100x100, written once to OUT_DIR."""
    import numpy as np

    from tinynerf_tpu_torch.synthetic import generate_synthetic_dataset

    path = os.path.join(OUT_DIR, "forward_facing.npz")
    if not os.path.exists(path):
        d = generate_synthetic_dataset(device=dev, forward_facing=True)
        np.savez(path, images=d["images"], poses=d["poses"], focal=d["focal"])
    return path


def pass_errors(loss, grads, fn, args, kw, dtype, names) -> dict:
    """A NeRF pass's gradients against its plain version `fn` on the same
    inputs (PERF.md section 2): bf16 loss rel., worst leaf cosine and the
    trunk and rgb_in leaves' scale; f32 against float64 sums (a float64
    copy of the MLP, args[0]), each leaf within 3e-4 of its max plus the
    f32 plain version's own error, capped at another 3e-4. loss None: a
    K7 backward (fn returns the gradients only)."""
    import copy

    mlp = args[0]

    def run(m):
        out = fn(m, *args[1:], **kw)
        return (out[0], list(out[1])) if loss is not None else (None, list(out))

    if dtype == torch.bfloat16:
        want_loss, want = run(mlp)
        err = {**leaf_errors(grads, want), "mma_scale_err": mma_scale_error(names, grads, want)}
        err["loss_rel"] = 0.0 if loss is None else abs(float(loss) - float(want_loss)) / float(want_loss)
        err["ok"] = (err["loss_rel"] < 1e-3 and err["min_cosine"] > 0.98
                     and err["mma_scale_err"] < MMA_SCALE)
        return err
    _, plain32 = run(mlp)
    want_loss, want = run(copy.deepcopy(mlp).double())
    want = [w.float() for w in want]
    err = leaf_errors(grads, want)
    err["loss_rel"] = 0.0 if loss is None else abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    ok = err["loss_rel"] < 1e-5
    for g, w, p in zip(grads, want, plain32):
        tol = 3e-4 * float(w.abs().max())
        ok = ok and float((g - w).abs().max()) <= tol + min(float((p - w).abs().max()), tol) + 1e-8
    err["ok"] = ok
    return err


def run_slice() -> None:
    """Phases 29-33: F3's widths on the CUDA-core kernels, NDC rays, the
    depth/acc (aux) rendering and the occupancy proposal (the slice)."""
    import dataclasses

    import numpy as np

    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import make_gif as gif_mod
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays, fused_nerf_render_rays_plain, render_uses_tensor_cores,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed, fused_nerf_pass_grads_streamed_plain,
        fused_nerf_render_rays_streamed, fused_nerf_render_rays_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads, fused_nerf_pass_grads_plain, make_fused_nerf_grad_fn,
        uses_tensor_cores,
    )
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain, block_partials_plain, fused_block_partials_bwd,
        fused_block_partials_fwd, make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.ops.occupancy import (
        aabb_from_rays, density_grid, grid_generator, make_occupancy_fused_grad_fn,
    )
    from tinynerf_tpu_torch.ops.rays import get_rays, get_rays_for_poses
    from tinynerf_tpu_torch.ops.volume import global_deltas
    from tinynerf_tpu_torch.render import (
        make_hierarchical_image_renderer, make_occupancy_image_renderer, unpack_aux,
    )
    from tinynerf_tpu_torch.training import (
        draw_ray_batch, make_train_step, settings_optimizer, step_generator,
    )
    from tinynerf_tpu_torch.utils.checkpoint import read_meta
    from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

    dev = torch.device("cuda", 0)
    card = card_line()
    k3, k5 = fused_nerf_render_rays, fused_nerf_render_rays_streamed
    k4, k6 = fused_nerf_pass_grads, fused_nerf_pass_grads_streamed
    fwd, bwd = fused_block_partials_fwd, fused_block_partials_bwd
    k1, k2 = fused_render_rays, fused_loss_grads
    all_kernels = (k1, k2, k3, k4, k5, k6, fwd, bwd)

    def reset():
        for k in all_kernels:
            k.launches = k.mma_launches = 0

    def counts(*ks):
        return [(k.launches, k.mma_launches) for k in ks]

    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    rays_o, rays_d = get_rays(H, W, focal, poses[0])
    idx = torch.randperm(H * W, generator=torch.Generator().manual_seed(0))[:N_RAYS_TRAIN].to(dev)
    ro, rd = rays_o[idx].contiguous(), rays_d[idx].contiguous()
    tgt = images[0].reshape(-1, 3)[idx].contiguous()
    R = N_RAYS_TRAIN

    # 29. F3: K3, K4, K5, K6 and the K7 pair at widths off the old rule
    #     (hidden 48 with rgb_hidden 64; 36 and 20, zero-padded to 40 and
    #     24), f32 and bf16, on the CUDA cores, against their plain versions.
    t0 = time.time()
    g = torch.Generator(device=dev).manual_seed(29)
    z_union = torch.sort(2.0 + 4.0 * torch.rand(R, 192, generator=g, device=dev), dim=1).values
    deltas = global_deltas(z_union, rd)
    z_sh, d_sh = z_union[:, 96:].contiguous(), deltas[:, 96:].contiguous()
    cot = {k: (0.5 + torch.rand(*shape, generator=g, device=dev)) / R
           for k, shape in (("C", (R, 3)), ("A", (R,)), ("T", (R,)), ("D", (R,)))}
    keys = ("C", "A", "T", "D")
    f3_times = {}
    for hidden, rgb_hidden in F3_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=dtype)
            check(not uses_tensor_cores(cfg) and not render_uses_tensor_cores(cfg),
                  f"hidden {hidden} rgb_hidden {rgb_hidden} routes to the CUDA cores")
            mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(29), device=dev)
            with torch.no_grad():
                # Density along every ray: a narrow random init can leave
                # every sigma at the ReLU's zero, and the pass no gradient.
                mlp.sigma.bias.add_(1.0)
            names = [n for n, _ in mlp.named_parameters()]
            reset()
            with torch.no_grad():
                c3, w3 = k3(mlp, ro, rd, n_samples=64, cfg=cfg, return_weights=True)
                c5 = k5(mlp, ro, rd, z_union, cfg=cfg, sample_block=64)
            loss4, grads4 = k4(mlp, ro, rd, tgt, 0, z_union[:, ::3].contiguous(), randomized=False,
                               cfg=cfg)
            loss6, grads6 = k6(mlp, ro, rd, tgt, z_union, cfg=cfg, sample_block=64)
            fn = make_fused_block_partials_fn(cfg, sample_block=48)
            partials, _ = fn(mlp, ro, rd, z_sh, d_sh)
            grads7 = torch.autograd.grad([partials[k] for k in keys], list(mlp.parameters()),
                                         grad_outputs=[cot[k] for k in keys])
            torch.cuda.synchronize()
            moved = counts(k3, k5, k4, k6, fwd, bwd)
            with torch.no_grad():
                want3, want_w3 = fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=64, cfg=cfg,
                                                              return_weights=True)
                want5 = fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z_union, cfg=cfg,
                                                              sample_block=64)
                want7, _ = block_partials_plain(mlp, ro, rd, z_sh, d_sh, None, cfg=cfg,
                                                sample_block=48)
            errs = {"K3": ray_errors(c3, want3), "K3 weights": ray_errors(w3, want_w3, width=64),
                    "K5": ray_errors(c5, want5)}
            errs.update({f"K7 fwd {k}": ray_errors(partials[k].detach() / (6.0 if k == "D" else 1.0),
                                                    want7[k] / (6.0 if k == "D" else 1.0),
                                                    width=3 if k == "C" else 1) for k in keys})
            render_ok = all(within(e, dtype) for e in errs.values())
            errs["K4"] = pass_errors(loss4, grads4, fused_nerf_pass_grads_plain,
                                     (mlp, ro, rd, tgt, 0, z_union[:, ::3].contiguous()),
                                     dict(randomized=False, cfg=cfg), dtype, names)
            errs["K6"] = pass_errors(loss6, grads6, fused_nerf_pass_grads_streamed_plain,
                                     (mlp, ro, rd, tgt, z_union), dict(cfg=cfg, sample_block=64),
                                     dtype, names)
            errs["K7 bwd"] = pass_errors(None, grads7, block_partials_grads_plain,
                                         (mlp, ro, rd, z_sh, d_sh, None, cot, None),
                                         dict(cfg=cfg, sample_block=48), dtype, names)
            print(f"[f3] {str(dtype).split('.')[-1]} hidden {hidden} rgb_hidden {rgb_hidden}, {R} "
                  f"rays (K3 S=64 weights out, K5 S=192 block 64, K4 S=64, K6 S=192 block 64, K7 "
                  f"a 96-sample shard block 48) against the plain versions: (launches, on the "
                  f"tensor cores) {moved}; {json.dumps(errs)}", flush=True)
            check(moved == [(1, 0)] * 6,
                  "K3, K5, K4, K6, K7 forward and backward once each, none on the tensor cores")
            check(render_ok, f"K3, K5 and K7's partials within the {dtype} render gates")
            check(all(errs[k]["ok"] for k in ("K4", "K6", "K7 bwd")),
                  f"K4, K6 and K7's backward within the {dtype} NeRF pass gates")
            if (hidden, rgb_hidden, dtype) != (48, 64, torch.bfloat16):
                continue
            # Timing at F3's example, bf16 on the CUDA cores: plain, kernel,
            # kernel, plain.
            def k7_pair(f):
                parts, _ = f(mlp, ro, rd, z_sh, d_sh)
                torch.autograd.grad([parts[k] for k in keys], list(mlp.parameters()),
                                    grad_outputs=[cot[k] for k in keys])

            def k7_plain():
                block_partials_plain(mlp, ro, rd, z_sh, d_sh, None, cfg=cfg, sample_block=48)
                block_partials_grads_plain(mlp, ro, rd, z_sh, d_sh, None, cot, None, cfg=cfg,
                                           sample_block=48)

            z64 = z_union[:, ::3].contiguous()
            cases = {
                "K3": (lambda: k3(mlp, ro, rd, n_samples=64, cfg=cfg, return_weights=True),
                       lambda: fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=64, cfg=cfg,
                                                            return_weights=True)),
                "K5": (lambda: k5(mlp, ro, rd, z_union, cfg=cfg, sample_block=64),
                       lambda: fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z_union, cfg=cfg,
                                                                     sample_block=64)),
                "K4": (lambda: k4(mlp, ro, rd, tgt, 0, z64, randomized=False, cfg=cfg),
                       lambda: fused_nerf_pass_grads_plain(mlp, ro, rd, tgt, 0, z64,
                                                           randomized=False, cfg=cfg)),
                "K6": (lambda: k6(mlp, ro, rd, tgt, z_union, cfg=cfg, sample_block=64),
                       lambda: fused_nerf_pass_grads_streamed_plain(mlp, ro, rd, tgt, z_union,
                                                                    cfg=cfg, sample_block=64)),
                "K7 pair": (lambda: k7_pair(fn), k7_plain),
            }
            times = {}
            with torch.no_grad():
                for what in ("K3", "K5"):
                    for i in (1, 0, 0, 1):
                        times.setdefault((what, i), []).append(cuda_ms(cases[what][i], iters=5))
            for what in ("K4", "K6", "K7 pair"):
                for i in (1, 0, 0, 1):
                    times.setdefault((what, i), []).append(cuda_ms(cases[what][i], iters=5))
            f3_times = {f"{w} {'plain' if i else 'kernel'}": min(v) for (w, i), v in times.items()}
            print(f"[timing] {card}: bf16 at hidden 48, rgb_hidden 64, on the CUDA cores, {R} "
                  f"rays: {json.dumps(f3_times)} (all runs "
                  f"{json.dumps({f'{w} {i}': v for (w, i), v in times.items()})})", flush=True)
            # Their bounds: operations (the forward MACs of a point for a
            # render, train_macs_per_point for a training pass) over the
            # bf16 peak, as the kernels line counts them, and over the f32
            # peak outside the tensor cores (the walk these widths take);
            # bytes: rays, depths, target, parameters in, gradients or
            # weights out, once.
            m_f, m_t = macs_per_point(mlp), train_macs_per_point(mlp)
            n_p = sum(p.numel() for p in mlp.parameters())
            work = {"K3": (2 * R * 64 * m_f, R * (6 + 64) + n_p + R * (3 + 64)),
                    "K5": (2 * R * 192 * m_f, R * (6 + 192) + n_p + R * 3),
                    "K4": (2 * R * 64 * m_t, R * (9 + 64) + 2 * n_p + R * 64 * 2),
                    "K6": (2 * R * 192 * m_t, R * (9 + 192) + 2 * n_p),
                    "K7 pair": (2 * R * 96 * m_t, R * (6 + 2 * 96 + 6) + 2 * n_p + R * 6)}
            bounds = {k: {"GFLOP": f / 1e9, "bf16_peak_ms": f / PEAK_FLOPS * 1e3,
                          "f32_peak_ms": f / PEAK_F32_FLOPS * 1e3,
                          "bytes_ms": 4 * b / PEAK_BYTES * 1e3} for k, (f, b) in work.items()}
            print(f"[timing] their bounds at hidden 48, rgb_hidden 64 ({m_f} forward MAC a point, "
                  f"{m_t} training): {json.dumps(bounds)}", flush=True)
    h48 = Config(model="nerf", hidden=48, n_fine=64, iters=F3_TRAIN_ITERS, log_every=10,
                 data_path=data_path, resume=False, out_dir=os.path.join(OUT_DIR, "nerf48_64"),
                 ckpt_path=os.path.join(OUT_DIR, "nerf48_64.npz"),
                 metrics_path=os.path.join(OUT_DIR, "nerf48_64.jsonl"))
    if os.path.exists(h48.metrics_path):
        os.unlink(h48.metrics_path)
    reset()
    train_mod.main(h48)
    h48_launches = counts(k4, k6)
    losses = [r["loss"] for r in map(json.loads, open(h48.metrics_path)) if "loss" in r]
    print(f"[f3] train --model nerf --hidden 48 (rgb_hidden {h48.rgb_hidden}) --n-fine 64, bf16 "
          f"fused, {F3_TRAIN_ITERS} steps: (K4, K6) (launches, on the tensor cores) "
          f"{h48_launches}, losses {losses}", flush=True)
    check(h48.rgb_hidden == 64 and h48_launches == [(2 * F3_TRAIN_ITERS, 0), (0, 0)]
          and all(math.isfinite(x) for x in losses),
          "hidden 48 with the default rgb_hidden trains fused: K4 twice a step, off the tensor "
          "cores; losses finite")
    print(f"[f3] ok in {time.time() - t0:.2f}s", flush=True)

    # 30. NDC: the forward-facing scene; TinyNeRF --ndc fused (K2, K1) and
    #     eager, 1000 steps; the flagship --ndc 20 steps and a resume, its
    #     K3 image against the eager one.
    t0 = time.time()
    ff_path = forward_facing_data(dev)
    ff = ensure_data(ff_path, device=dev)
    ff_poses = torch.from_numpy(ff["poses"]).to(dev)
    ndc_runs = {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        cfg = Config(ndc=True, data_path=ff_path, iters=TRAIN_ITERS, holdout=4, resume=False,
                     fused_train=fused, out_dir=os.path.join(OUT_DIR, f"ndc_tiny_{name}"),
                     ckpt_path=os.path.join(OUT_DIR, f"ndc_tiny_{name}.npz"),
                     metrics_path=os.path.join(OUT_DIR, f"ndc_tiny_{name}.jsonl"))
        if os.path.exists(cfg.metrics_path):
            os.unlink(cfg.metrics_path)
        reset()
        res = train_mod.main(cfg)
        psnrs = logged_psnrs(cfg.metrics_path)
        ndc_runs[name] = {"k2": counts(k2)[0], "k1": counts(k1)[0], "rise": psnrs[-1] - psnrs[0],
                          "heldout": res["eval"]["psnr_mean"]}
        print(f"[ndc] TinyNeRF --ndc {name}, {TRAIN_ITERS} steps on the forward-facing scene: "
              f"(K2, K1) (launches, on the tensor cores) {ndc_runs[name]['k2']}, "
              f"{ndc_runs[name]['k1']}; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, held-out "
              f"{res['eval']['psnr_mean']:.2f} dB", flush=True)
        check(ndc_runs[name]["rise"] >= 3.0, f"{name} --ndc train PSNR rises >= 3 dB")
    check(ndc_runs["fused"]["k2"] == (TRAIN_ITERS, TRAIN_ITERS) and ndc_runs["eager"]["k2"] == (0, 0)
          and ndc_runs["fused"]["k1"][0] > 0 and ndc_runs["fused"]["k1"][0] == ndc_runs["fused"]["k1"][1],
          "--ndc fused: K2 once a step and K1 rendering, every launch on the tensor cores")
    gap = abs(ndc_runs["fused"]["heldout"] - ndc_runs["eager"]["heldout"])
    print(f"[ndc] TinyNeRF held-out PSNR fused vs eager: {gap:.3f} dB apart", flush=True)
    check(gap <= 1.5, "--ndc fused and eager held-out PSNR within 1.5 dB")
    nflag = Config(model="nerf", hidden=256, n_fine=128, ndc=True, data_path=ff_path,
                   iters=NDC_FLAGSHIP_ITERS, holdout=4, resume=False, log_every=10,
                   out_dir=os.path.join(OUT_DIR, "ndc_flagship"),
                   ckpt_path=os.path.join(OUT_DIR, "ndc_flagship.npz"),
                   metrics_path=os.path.join(OUT_DIR, "ndc_flagship.jsonl"))
    if os.path.exists(nflag.metrics_path):
        os.unlink(nflag.metrics_path)
    reset()
    train_mod.main(nflag)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main(dataclasses.replace(nflag, iters=NDC_FLAGSHIP_ITERS + 5, resume=True))
    flag_launches = counts(k4, k6)
    losses = [r["loss"] for r in map(json.loads, open(nflag.metrics_path)) if "loss" in r]
    meta = read_meta(nflag.ckpt_path)["meta"]["cfg"]
    print(f"[ndc] flagship --ndc {NDC_FLAGSHIP_ITERS} steps and a resume to "
          f"{NDC_FLAGSHIP_ITERS + 5}: (K4, K6) (launches, on the tensor cores) {flag_launches}, "
          f"losses {losses}, meta ndc {meta['ndc']}", flush=True)
    check(flag_launches == [(NDC_FLAGSHIP_ITERS + 5,) * 2] * 2 and meta["ndc"] is True
          and "[resume]" in out.getvalue() and all(math.isfinite(x) for x in losses),
          "flagship --ndc: K4 and K6 once a step on the tensor cores, resumed; meta ndc")
    imgs = {}
    for fused in (True, False):
        model, ren, _ = load_model_and_renderer(nflag.ckpt_path, H=H, W=W, focal=float(ff["focal"]),
                                                fused=fused, device=dev)
        reset()
        imgs[fused] = ren(model, ff_poses[-1])
        torch.cuda.synchronize()
        if fused:
            k3_launches = counts(k3)[0]
    err = ray_errors(imgs[True].reshape(-1, 3), imgs[False].reshape(-1, 3))
    print(f"[ndc] flagship --ndc 100x100 image, K3 (launches, on the tensor cores) {k3_launches} "
          f"against eager: {json.dumps(err)}", flush=True)
    check(k3_launches[0] > 0 and k3_launches[0] == k3_launches[1] and within(err, torch.bfloat16)
          and bool(torch.isfinite(imgs[True]).all()),
          "the --ndc flagship's K3 image within the bf16 render gates of the eager one")
    print(f"[ndc] ok in {time.time() - t0:.2f}s", flush=True)

    # 31. aux: eval --save-depth and make_gif --depth on the flagship (the
    #     phase-27 lever run, 250 steps) and the NDC checkpoints.
    t0 = time.time()
    aux_cases = (("flagship", os.path.join(OUT_DIR, "levers", "flagship.npz"), data_path, True),
                 ("ndc TinyNeRF", os.path.join(OUT_DIR, "ndc_tiny_fused.npz"), ff_path, True),
                 ("ndc flagship", nflag.ckpt_path, ff_path, False))
    for name, ckpt, dpath, trained in aux_cases:
        tag = name.replace(" ", "_")
        dset = ensure_data(dpath, device=dev)
        out_dir = os.path.join(OUT_DIR, f"depth_{tag}")
        eval_mod.main(eval_mod.EvalConfig(ckpt_path=ckpt, data_path=dpath, views=2,
                                          save_depth=True, out_dir=out_dir))
        written = sorted(f for f in os.listdir(out_dir) if f.startswith(("depth_", "acc_")))
        ndc = bool(read_meta(ckpt)["meta"]["cfg"].get("ndc"))
        near, far = (0.0, 1.0) if ndc else (2.0, 6.0)
        model, aux_ren, _ = load_model_and_renderer(ckpt, H=H, W=W, focal=float(dset["focal"]),
                                                    aux=True, device=dev)
        depth, acc = unpack_aux(aux_ren(model, torch.from_numpy(dset["poses"][-1]).to(dev)),
                                near, far)
        mask = acc > 0.5
        dm = depth[mask]
        frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=ckpt, data_path=dpath, n_frames=8,
                                                depth=True,
                                                out_path=os.path.join(OUT_DIR, f"depth_{tag}.gif")))
        stats = {"files": written, "acc>0.5 pixels": int(mask.sum()),
                 "depth range": [float(dm.min()), float(dm.max())] if dm.numel() else None,
                 "depth std": float(dm.std()) if dm.numel() > 1 else None,
                 "gif frames": list(frames.shape), "gif std": float(frames.std())}
        print(f"[aux] {name} ({ckpt}): eval --save-depth and make_gif --depth, near {near} far "
              f"{far}: {json.dumps(stats)}", flush=True)
        check(len(written) == 4 and bool(torch.isfinite(depth).all() and torch.isfinite(acc).all())
              and bool(((dm >= near) & (dm <= far)).all()) and frames.dtype == np.uint8,
              f"{name}: depth and acc maps written, finite, the depth inside [near, far] where "
              "acc > 0.5; the depth GIF written")
        if trained:
            check(dm.numel() >= 20 and float(dm.std()) > 0 and float(frames.std()) > 0,
                  f"{name}: the depth is not constant where acc > 0.5")
    print(f"[aux] ok in {time.time() - t0:.2f}s", flush=True)

    # 32. the slice: the flagship occupancy proposal (one MLP, 64 + 128 =
    #     192 grid-proposed samples through K6, a 64^3 grid over the
    #     capture's box, served through K5), 200 steps fused and a resume
    #     to 250, and 200 steps eager; its K5 image against the eager one;
    #     then the occupancy step, the grid rebuild and the image timed
    #     against the hierarchical flagship.
    t0 = time.time()
    occ_runs = {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        occ = Config(model="nerf", hidden=256, n_fine=128, proposal="occupancy", fused_train=fused,
                     data_path=data_path, iters=OCC_ITERS, holdout=4, resume=False, log_every=10,
                     out_dir=os.path.join(OUT_DIR, f"occ_{name}"),
                     ckpt_path=os.path.join(OUT_DIR, f"occ_{name}.npz"),
                     metrics_path=os.path.join(OUT_DIR, f"occ_{name}.jsonl"))
        if os.path.exists(occ.metrics_path):
            os.unlink(occ.metrics_path)
        reset()
        res = train_mod.main(occ)
        launches = dict(zip(("K4", "K6", "K3", "K5"), counts(k4, k6, k3, k5)))
        psnrs = logged_psnrs(occ.metrics_path)
        occ_runs[name] = {"launches": launches, "heldout": res["eval"]["psnr_mean"],
                          "rise": psnrs[-1] - psnrs[0], "rays_per_sec": res["rays_per_sec"],
                          "cfg": occ}
        print(f"[occupancy] flagship --proposal occupancy {name}, {OCC_ITERS} steps: (launches, "
              f"on the tensor cores) {json.dumps(launches)}; train PSNR {psnrs[0]:.2f} -> "
              f"{psnrs[-1]:.2f} dB, held-out {res['eval']['psnr_mean']:.2f} dB, "
              f"{res['rays_per_sec']:,.0f} rays/s", flush=True)
        check(launches["K4"] == launches["K3"] == (0, 0) and launches["K5"][0] > 0
              and launches["K5"][0] == launches["K5"][1]
              and launches["K6"] == ((OCC_ITERS, OCC_ITERS) if fused else (0, 0))
              and all(math.isfinite(x) for x in psnrs),
              f"occupancy {name}: K6 once a step (fused), K5 serving, every launch on the tensor "
              "cores; no K4, no K3")
    occ = occ_runs["fused"]["cfg"]
    out = io.StringIO()
    reset()
    with contextlib.redirect_stdout(out):
        train_mod.main(dataclasses.replace(occ, iters=OCC_ITERS + 50, resume=True))
    resumed = counts(k6)[0]
    meta = read_meta(occ.ckpt_path)["meta"]["cfg"]
    print(f"[occupancy] resume to {OCC_ITERS + 50}: K6 (launches, on the tensor cores) {resumed}; "
          f"meta proposal {meta['proposal']}, occ_aabb {meta['occ_aabb']}", flush=True)
    check(resumed == (50, 50) and f"from step {OCC_ITERS}" in out.getvalue()
          and meta["proposal"] == "occupancy" and len(meta["occ_aabb"]) == 2,
          "the occupancy run resumes: K6 once a step for the last 50, on the tensor cores")
    gap = abs(occ_runs["fused"]["heldout"] - occ_runs["eager"]["heldout"])
    print(f"[occupancy] held-out PSNR fused vs eager: {gap:.3f} dB apart", flush=True)
    check(gap <= 1.5, "occupancy fused and eager held-out PSNR within 1.5 dB")
    imgs = {}
    for fused in (True, False):
        model, ren, _ = load_model_and_renderer(occ.ckpt_path, H=H, W=W, focal=focal, fused=fused,
                                                device=dev)
        reset()
        imgs[fused] = ren(model, poses[-1])
        torch.cuda.synchronize()
        if fused:
            k5_launches = counts(k5)[0]
    err = ray_errors(imgs[True].reshape(-1, 3), imgs[False].reshape(-1, 3))
    print(f"[occupancy] 100x100 image through K5 (launches, on the tensor cores) {k5_launches} "
          f"against the eager render: {json.dumps(err)}", flush=True)
    check(k5_launches[0] == 3 and k5_launches[1] == 3 and within(err, torch.bfloat16),
          "the occupancy image: K5 once a chunk on the tensor cores, within the bf16 render gates")
    # Timing, in turns: the occupancy step against the hierarchical one
    # (fused, 2048 rays, 192 samples a ray through one MLP against 64 + 192
    # through two), the grid rebuild alone, the images.
    ncfg = Config(model="nerf", hidden=256).nerf_cfg()
    hier_s = Config(model="nerf", hidden=256, n_fine=128).train_settings()
    occ_s = dataclasses.replace(hier_s, n_samples=192)
    train_poses = poses[: n_images - 4]
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, train_poses)
    pixels = images[: n_images - 4].reshape(len(train_poses), H * W, 3)
    box = aabb_from_rays(*get_rays_for_poses(H, W, focal, poses), 2.0, 6.0)
    hier = NeRF(ncfg, generator=torch.Generator().manual_seed(0), device=dev)
    occm = NeRF(ncfg, generator=torch.Generator().manual_seed(0), device=dev, parts=("fine",))
    hier_opt = settings_optimizer(hier.parameters(), hier_s)
    occ_opt = settings_optimizer(occm.parameters(), occ_s)
    hier_step = make_train_step(hier_s, grad_fn=make_fused_nerf_grad_fn(hier_s, ncfg, n_fine=128))
    occ_fn = make_occupancy_fused_grad_fn(ncfg, aabb=box)
    grid = density_grid(occm.fine, ncfg, resolution=64, aabb=box)
    counter = iter(range(10**6))

    def occ_step():
        step = next(counter)
        gen = step_generator(0, step, dev)
        o, dd, tt = draw_ray_batch(occ_s, gen, step, rays_o_all, rays_d_all, pixels)
        occ_opt.zero_grad(set_to_none=True)
        occ_fn(occm, grid, o, dd, tt, gen, occ_s)
        occ_opt.step()

    hier_ren = make_hierarchical_image_renderer(H=H, W=W, focal=focal, n_coarse=64, n_fine=128,
                                                nerf_cfg=ncfg, use_fused=True)
    occ_ren = make_occupancy_image_renderer(H=H, W=W, focal=focal, n_samples=192, nerf_cfg=ncfg,
                                            use_fused=True, aabb=box)
    cases = {
        "hierarchical step": lambda: hier_step(hier, hier_opt, 0, next(counter), rays_o_all,
                                               rays_d_all, pixels),
        "occupancy step": occ_step,
        "grid rebuild": lambda: density_grid(occm.fine, ncfg, resolution=64, aabb=box,
                                             generator=grid_generator(0, 0, dev)),
        "hierarchical image": lambda: hier_ren(hier, poses[-1]),
        "occupancy image": lambda: occ_ren(occm, poses[-1]),
    }
    times = {}
    for name in ("hierarchical step", "occupancy step", "occupancy step", "hierarchical step",
                 "grid rebuild", "grid rebuild", "hierarchical image", "occupancy image",
                 "occupancy image", "hierarchical image"):
        times.setdefault(name, []).append(cuda_ms(cases[name], iters=5))
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: flagship, bf16, fused: the occupancy step (2048 rays, 192 grid-"
          f"proposed samples, K6) {ms['occupancy step']:.4f} ms against the hierarchical step "
          f"{ms['hierarchical step']:.4f} ms; the 64^3 grid rebuild {ms['grid rebuild']:.4f} ms; a "
          f"100x100 image, occupancy (grid + K5) {ms['occupancy image']:.4f} ms against "
          f"hierarchical (K3 twice a chunk) {ms['hierarchical image']:.4f} ms (all runs "
          f"{json.dumps(times)})", flush=True)
    print(f"[occupancy] ok in {time.time() - t0:.2f}s", flush=True)

    # 33. --data-parallel --proposal occupancy on two ranks sharing the card,
    #     10 steps; then a short --proposal occupancy --ndc run.
    t0 = time.time()
    dp = torchrun_train("occ_dp", "--proposal", "occupancy", "--iters", str(OCC_DP_ITERS),
                        "--no-resume")
    dp_launches = [(r.get("fused_nerf_pass_grads_streamed", 0),
                    r.get("fused_nerf_pass_grads_streamed.mma_launches", 0),
                    r.get("fused_nerf_pass_grads", 0)) for r in dp["launches"]]
    print(f"[occupancy] --data-parallel on 2 ranks, {OCC_DP_ITERS} steps: (K6, on the tensor "
          f"cores, K4) per rank {dp_launches}", flush=True)
    check(all(x == (OCC_DP_ITERS, OCC_DP_ITERS, 0) for x in dp_launches),
          "each rank's K6 once a step, on the tensor cores (replicas bit-identical: torchrun_train)")
    sp = torchrun_train("ndc_sp", "--ndc", "--data-path", ff_path, "--sample-parallel", "2",
                        "--iters", str(NDC_SP_ITERS), "--log-every", str(NDC_SP_ITERS),
                        "--no-resume")
    sp_launches = [tuple(r.get(k, 0) for k in ("fused_block_partials_fwd",
                                               "fused_block_partials_fwd.mma_launches",
                                               "fused_block_partials_bwd",
                                               "fused_block_partials_bwd.mma_launches"))
                   for r in sp["launches"]]
    print(f"[ndc] --ndc --data-parallel --sample-parallel 2 on 2 ranks, {NDC_SP_ITERS} steps: K7 "
          f"(forward, on the tensor cores, backward, on the tensor cores) per rank {sp_launches}",
          flush=True)
    check("[ndc] rays reprojected" in sp["out"]
          and all(x == (2 * NDC_SP_ITERS,) * 4 for x in sp_launches),
          "--ndc sample-parallel: each rank's K7 twice a step (coarse and fine shards), on the "
          "tensor cores (replicas bit-identical: torchrun_train)")
    ondc = Config(model="nerf", hidden=256, n_fine=128, proposal="occupancy", ndc=True,
                  data_path=ff_path, iters=OCC_SHORT_ITERS, holdout=4, resume=False, log_every=10,
                  out_dir=os.path.join(OUT_DIR, "occ_ndc"),
                  ckpt_path=os.path.join(OUT_DIR, "occ_ndc.npz"),
                  metrics_path=os.path.join(OUT_DIR, "occ_ndc.jsonl"))
    if os.path.exists(ondc.metrics_path):
        os.unlink(ondc.metrics_path)
    reset()
    res = train_mod.main(ondc)
    launches = counts(k6, k5)
    losses = [r["loss"] for r in map(json.loads, open(ondc.metrics_path)) if "loss" in r]
    meta = read_meta(ondc.ckpt_path)["meta"]["cfg"]
    print(f"[occupancy] --proposal occupancy --ndc, {OCC_SHORT_ITERS} steps: (K6, K5) (launches, "
          f"on the tensor cores) {launches}, losses {losses}, held-out "
          f"{res['eval']['psnr_mean']:.2f} dB, occ_aabb {meta['occ_aabb']}", flush=True)
    check(launches[0] == (OCC_SHORT_ITERS, OCC_SHORT_ITERS) and launches[1][0] > 0
          and launches[1][0] == launches[1][1] and all(math.isfinite(x) for x in losses)
          and meta["ndc"] is True and meta["occ_aabb"] == [[-1.0] * 3, [1.0] * 3],
          "occupancy + NDC: K6 once a step and K5 serving on the tensor cores, the NDC cube as "
          "the grid's box")
    print(f"[occupancy] ok in {time.time() - t0:.2f}s", flush=True)


GRID_ITERS = 1000  # phase 34: the grid recipe, then a resume to +200
GRID_DP_ITERS = 10  # phase 34: the 2-rank data-parallel grid run
GRID_NDC_ITERS = 20  # phase 34: --model grid --ndc
GRID_REG_ITERS = 50  # phase 34: the regularized grid levers
LATTICE_ITERS = 2000  # phase 35: the lattice's flagship precrop probe
LATTICE_NO_PRECROP_ITERS = 600  # phase 35: the same recipe without precrop (a reading)
LATTICE_SHAPE = (106, 100, 100)  # phase 35: the lattice capture, the JAX package's default
LATTICE_CPU_POSES = (0, 53, 105)  # phase 35: lattice poses rendered again on the CPU
# The grid recipe (README's, as the JAX package's r4 grid legs ran it,
# benchmarks/grid_r4.sh) and the lattice's flagship precrop probe
# (benchmarks/hardscene_r5.sh p1_precrop).
GRID_RECIPE = dict(model="grid", lr=0.01, lr_decay_steps=20000, ray_sampling="pool",
                   sigma_noise_std=1.0, sigma_noise_decay_steps=1000, holdout=4)
LATTICE_RECIPE = dict(model="nerf", hidden=256, n_fine=128, ray_sampling="pool",
                      sigma_noise_std=1.0, sigma_noise_decay_steps=2000, precrop_iters=500,
                      precrop_frac=0.5, lr_decay_steps=20000, holdout=4)
JAX_GRID_PSNR_1000 = 25.30  # benchmarks/r4/grid20k_train.jsonl, step 1000 (a TPU run)
JAX_LATTICE_HELDOUT_2000 = 31.05  # benchmarks/r5/p1_precrop_train.jsonl, step 2000 (a TPU run)
LATTICE_MIN_PSNR = 14.5  # benchmarks/pick_hard_winner.py:19: the background floor + ~3 dB


def _all_kernels():
    from tinynerf_tpu_torch.kernels.fused_nerf import fused_nerf_render_rays
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed, fused_nerf_render_rays_streamed,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads
    from tinynerf_tpu_torch.kernels.fused_partials import (
        fused_block_partials_bwd, fused_block_partials_fwd,
    )
    from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads

    return {"K1": fused_render_rays, "K2": fused_loss_grads, "K3": fused_nerf_render_rays,
            "K4": fused_nerf_pass_grads, "K5": fused_nerf_render_rays_streamed,
            "K6": fused_nerf_pass_grads_streamed, "K7 fwd": fused_block_partials_fwd,
            "K7 bwd": fused_block_partials_bwd}


def run_grid() -> None:
    """Phase 34: the grid family (the encoding on kernel G, the rest eager
    torch) at the JAX package's default width."""
    import dataclasses

    import numpy as np

    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import make_gif as gif_mod
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels import grid_encode as G
    from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, make_grid_loss
    from tinynerf_tpu_torch.models.tinynerf import count_params
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays
    from tinynerf_tpu_torch.ops.rays import get_rays_for_poses
    from tinynerf_tpu_torch.render import make_grid_image_renderer
    from tinynerf_tpu_torch.training import make_train_step, settings_optimizer, step_generator
    from tinynerf_tpu_torch.utils.checkpoint import read_meta, restore_params

    os.makedirs(OUT_DIR, exist_ok=True)  # also when the phase runs alone
    dev = torch.device("cuda", 0)
    card = card_line()
    kernels = _all_kernels()

    def reset():
        for k in kernels.values():
            k.launches = k.mma_launches = 0

    def counts():
        return {n: (k.launches, k.mma_launches) for n, k in kernels.items()}

    none = {n: (0, 0) for n in kernels}
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene
    d = ensure_data(data_path, device=dev)
    images = torch.from_numpy(d["images"]).to(dev)
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape

    # 34. (a) the recipe, 1000 steps (G once forward and once backward a
    #     step), a resume to 1200 and an uninterrupted 1200 (bit-identical);
    #     eval and the depth GIF from the checkpoint; none of K1-K7 launched
    #     anywhere in the phase.
    t0 = time.time()
    reset()

    def grid_cfg(tag, **kw):
        base = dict(GRID_RECIPE, data_path=data_path, iters=GRID_ITERS, resume=False,
                    out_dir=os.path.join(OUT_DIR, tag), ckpt_path=os.path.join(OUT_DIR, f"{tag}.npz"),
                    metrics_path=os.path.join(OUT_DIR, f"{tag}.jsonl"))
        base.update(kw)
        cfg = Config(**base)
        if os.path.exists(cfg.metrics_path) and not cfg.resume:
            os.unlink(cfg.metrics_path)
        return cfg

    gcfg = grid_cfg("grid")
    out = io.StringIO()
    G.grid_encode_fwd.launches = G.grid_encode_bwd.launches = 0
    with contextlib.redirect_stdout(out):
        res = train_mod.main(gcfg)
    g_launches = (G.grid_encode_fwd.launches, G.grid_encode_bwd.launches)
    text = out.getvalue()
    print("\n".join(line for line in text.splitlines()
                    if line.startswith(("[model]", "[train] grid", "[eval]", "[done]"))), flush=True)
    psnrs = logged_psnrs(gcfg.metrics_path)
    model = res["model"]
    print(f"[grid] train --model grid (the README recipe), {GRID_ITERS} steps of {gcfg.n_rand} rays "
          f"x {gcfg.n_samples} samples, bf16, {count_params(model):,} parameters, levels "
          f"{model.cfg.level_resolutions()}: train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB (the JAX "
          f"package's r4 leg read {JAX_GRID_PSNR_1000} dB at step {GRID_ITERS}, a TPU run), held-out "
          f"{res['eval']['psnr_mean']:.2f} dB, {res['rays_per_sec']:,.0f} rays/s; G's launches "
          f"(forward, backward) {g_launches}", flush=True)
    check(isinstance(model, GridNeRF) and count_params(model) == 1273971
          and sum(model.cfg.level_is_dense()) == 4 and "kernels/grid_encode.py" in text,
          "the grid family at the JAX package's default width (1,273,971 parameters, 4 dense "
          "levels), the encoding on kernel G")
    per_bwd = G.launches(model.cfg.n_levels, model.cfg.features, True)
    check(g_launches[0] >= GRID_ITERS and g_launches[1] == GRID_ITERS * per_bwd,
          "G's forward at least once a step and its backward exactly once a step")
    check(psnrs[-1] - psnrs[0] >= 3.0, "grid train PSNR rises >= 3 dB")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main(dataclasses.replace(gcfg, iters=GRID_ITERS + 200, resume=True))
    check(f"from step {GRID_ITERS}" in out.getvalue(), "the grid run resumes from its checkpoint")
    whole = grid_cfg("grid_whole", iters=GRID_ITERS + 200, log_every=GRID_ITERS + 200)
    with contextlib.redirect_stdout(io.StringIO()):
        train_mod.main(whole)
    a, b = (GridNeRF(model.cfg, device=dev) for _ in range(2))
    restore_params(gcfg.ckpt_path, a)
    restore_params(whole.ckpt_path, b)
    a.requires_grad_(False)
    diffs = {n: float((x - y).abs().max()) for (n, x), y in
             zip(a.named_parameters(), b.parameters())}
    print(f"[grid] resumed 1000 -> 1200 against an uninterrupted 1200: max |difference| per leaf "
          f"{json.dumps(diffs)}", flush=True)
    check(all(v == 0 for v in diffs.values()),
          "the resumed grid run is bit-identical to an uninterrupted one (G's backward sums "
          "each entry's terms in a fixed order)")
    ev_dir = os.path.join(OUT_DIR, "grid_eval")
    ev = eval_mod.main(eval_mod.EvalConfig(ckpt_path=gcfg.ckpt_path, data_path=data_path, views=2,
                                           holdout_views=True, save_depth=True, out_dir=ev_dir))
    frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=gcfg.ckpt_path, data_path=data_path,
                                            n_frames=8, depth=True,
                                            out_path=os.path.join(OUT_DIR, "grid_depth.gif")))
    written = sorted(f for f in os.listdir(ev_dir) if f.startswith(("depth_", "acc_")))
    print(f"[grid] eval --holdout-views --save-depth: PSNR {ev['psnr_mean']:.2f} dB, {written}; "
          f"make_gif --depth: frames {list(frames.shape)}, std {float(frames.std()):.2f}", flush=True)
    check(math.isfinite(ev["psnr_mean"]) and len(written) == 2 * gcfg.holdout
          and frames.shape == (8, H, W, 3)
          and float(frames.std()) > 0, "eval and make_gif --depth from the grid checkpoint")
    launched = counts()
    print(f"[grid] K1-K7 (launches, on the tensor cores) over the trains, the resume, eval and "
          f"the GIF: {json.dumps(launched)}", flush=True)
    check(launched == none, "the grid path launches none of K1-K7")
    print(f"[grid] (a) ok in {time.time() - t0:.2f}s", flush=True)

    # 34. (b) --data-parallel on 2 ranks sharing the card; --ndc on the
    #     forward-facing scene; the regularized levers (AdamW, EMA, prior).
    t0 = time.time()
    dp = torchrun_train("grid_dp", *[a for k, v in GRID_RECIPE.items() for a in
                                      (f"--{k.replace('_', '-')}", str(v))],
                        "--iters", str(GRID_DP_ITERS), "--no-resume")
    dp_launches = [sum(v for k, v in r.items() if not k.startswith("grid_encode"))
                   for r in dp["launches"]]
    dp_bwd = [r.get("grid_encode_bwd", 0) for r in dp["launches"]]
    print(f"[grid] --data-parallel on 2 ranks, {GRID_DP_ITERS} steps: K1-K7 launches per rank "
          f"{dp_launches}, G's backward launches per rank {dp_bwd}, {dp['rays_per_sec']:,.0f} "
          f"rays/s (two processes on one card)", flush=True)
    check(dp_launches == [0, 0] and all(n == GRID_DP_ITERS * per_bwd for n in dp_bwd)
          and "[model] grid" in dp["out"],
          "grid data-parallel: G's backward once a step and none of K1-K7 on either rank "
          "(replicas bit-identical: torchrun_train)")
    ff_path = forward_facing_data(dev)
    reset()
    ndc = grid_cfg("grid_ndc", ndc=True, data_path=ff_path, iters=GRID_NDC_ITERS, log_every=10)
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_mod.main(ndc)
    losses = [r["loss"] for r in map(json.loads, open(ndc.metrics_path)) if "loss" in r]
    box = read_meta(ndc.ckpt_path)["meta"]["cfg"]["grid"]["aabb"]
    print(f"[grid] --ndc, {GRID_NDC_ITERS} steps on the forward-facing scene: losses {losses}, box "
          f"{box}, held-out {res['eval']['psnr_mean']:.2f} dB", flush=True)
    check(all(math.isfinite(x) for x in losses) and box == [-1.0] * 3 + [1.0] * 3
          and counts() == none, "grid --ndc: finite, the NDC cube as the box, none of K1-K7")
    reg = grid_cfg("grid_reg", iters=GRID_REG_ITERS, log_every=10, weight_decay=1e-4,
                   ema_decay=0.999, sigma_sparsity=1e-3, sigma_noise_floor=0.1,
                   sigma_noise_decay_steps=8000)
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_mod.main(reg)
    losses = [r["loss"] for r in map(json.loads, open(reg.metrics_path)) if "loss" in r]
    print(f"[grid] the regularized levers (benchmarks/gridreg_r5.sh: AdamW 1e-4, EMA 0.999, noise "
          f"decay 8000 to 0.1) and the sparsity prior 1e-3, {GRID_REG_ITERS} steps: losses {losses}, "
          f"held-out {res['eval']['psnr_mean']:.2f} dB, EMA {res['eval_ema']['psnr_mean']:.2f} dB",
          flush=True)
    check(all(math.isfinite(x) for x in losses) and os.path.exists(reg.ckpt_path + ".ema.npz")
          and counts() == none, "grid levers: finite, the EMA twin written, none of K1-K7")
    print(f"[grid] (b) ok in {time.time() - t0:.2f}s", flush=True)

    # 34. (c) timing: a step (2048 rays x 64 samples), a 100x100 image; the
    #     tables' gradient twice from one state, bit-identical.
    t0 = time.time()
    s = gcfg.train_settings()
    box = aabb_from_rays(*get_rays_for_poses(H, W, focal, poses), 2.0, 6.0)
    mcfg = gcfg.grid_cfg(aabb=box)
    timed = GridNeRF(mcfg, generator=torch.Generator().manual_seed(0), device=dev)
    opt = settings_optimizer(timed.parameters(), s)
    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, poses[: n_images - 4])
    pixels = images[: n_images - 4].reshape(n_images - 4, H * W, 3)
    step_fn = make_train_step(s, loss=make_grid_loss(mcfg))
    counter = iter(range(10**6))
    ren = make_grid_image_renderer(H=H, W=W, focal=focal, grid_cfg=mcfg)
    times = {}
    for name in ("step", "image", "image", "step"):
        fn = ((lambda: step_fn(timed, opt, 0, next(counter), rays_o_all, rays_d_all, pixels))
              if name == "step" else (lambda: ren(timed, poses[-1])))
        times.setdefault(name, []).append(cuda_ms(fn, iters=20))
    ms = {k: min(v) for k, v in times.items()}
    loss = make_grid_loss(mcfg)
    grads = []
    for _ in range(2):
        timed.zero_grad()
        with torch.enable_grad():
            value, _ = loss(timed, *draw_batch(s, 7, rays_o_all, rays_d_all, pixels),
                            step_generator(0, 7, dev), s)
            value.backward()
        grads.append([p.grad.clone() for p in timed.tables.values()])
    same = all(torch.equal(x, y) for x, y in zip(*grads))
    print(f"[timing] {card}: the grid family, bf16, the encoding on G: a step ({s.n_rand} rays x "
          f"{s.n_samples} samples) {ms['step']:.4f} ms = {1e3 / ms['step']:.2f} steps/s = "
          f"{s.n_rand * 1e3 / ms['step']:,.0f} rays/s; a 100x100 image {ms['image']:.4f} ms (all "
          f"runs {json.dumps(times)}); the tables' gradient bit-identical across two backward "
          f"passes from one state: {same}", flush=True)
    check(same, "the tables' gradient is bit-identical across two backward passes on the card")
    print(f"[grid] (c) ok in {time.time() - t0:.2f}s", flush=True)


def draw_batch(s, step, rays_o_all, rays_d_all, pixels):
    """One step's (rays_o, rays_d, target) drawn as training.draw_ray_batch
    draws it, from a fresh step generator."""
    from tinynerf_tpu_torch.training import draw_ray_batch, step_generator

    gen = step_generator(0, step, rays_o_all.device)
    return draw_ray_batch(s, gen, step, rays_o_all, rays_d_all, pixels)


def run_scenes() -> None:
    """Phase 35: the rest of synthetic.py (the lattice and the seeded
    scenes) and the lattice's flagship precrop probe through K4/K6/K3."""
    import dataclasses

    import numpy as np

    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import load_tiny_nerf_npz
    from tinynerf_tpu_torch.synthetic import generate_synthetic_dataset, render_ground_truth

    dev = torch.device("cuda", 0)
    kernels = _all_kernels()

    def reset():
        for k in kernels.values():
            k.launches = k.mma_launches = 0

    # 35. (a) the writer on the card, timed; its images against the same
    #     poses on the CPU; the white share; seeds 1 and 2.
    t0 = time.time()
    lattice_path = os.path.join(OUT_DIR, "lattice.npz")
    t_gen = time.time()
    n, h, w = LATTICE_SHAPE
    proc = subprocess.run([sys.executable, "-m", "tinynerf_tpu_torch.synthetic", "--out",
                           lattice_path, "--scene", "lattice", "--n-poses", str(n), "--h", str(h),
                           "--w", str(w)], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": os.getcwd()})
    t_gen = time.time() - t_gen
    print(proc.stdout.strip(), proc.stderr.strip()[-2000:], flush=True)
    check(proc.returncode == 0, "python -m tinynerf_tpu_torch.synthetic --scene lattice exits 0")
    lat = load_tiny_nerf_npz(lattice_path)
    imgs = lat["images"]
    errs = []
    for i in LATTICE_CPU_POSES:
        cpu = render_ground_truth(torch.from_numpy(lat["poses"][i]), h=h, w=w,
                                  scene="lattice").numpy()
        errs.append(float(np.abs(cpu - imgs[i]).max()))
    white = float((imgs.min(axis=-1) >= 1.0 - 1.0 / 255).mean())
    print(f"[scenes] the lattice ({imgs.shape[0]} poses of {imgs.shape[1]}x{imgs.shape[2]}, 256 "
          f"samples a ray) written on the card in {t_gen:.2f} s (the process included); poses "
          f"{list(LATTICE_CPU_POSES)} rendered again on the CPU: max |difference| {errs}; white "
          f"share (every channel within 1/255 of 1) {white:.4f}", flush=True)
    check(imgs.shape == (*LATTICE_SHAPE, 3) and bool(np.isfinite(imgs).all())
          and max(errs) <= 1e-4, "the lattice's card images match the CPU's within 1e-4")
    seeded = [generate_synthetic_dataset(n_poses=8, seed=k, device=dev)["images"] for k in (1, 2)]
    gap = float(np.abs(seeded[0] - seeded[1]).max())
    print(f"[scenes] seeds 1 and 2 (8 poses each): finite {all(np.isfinite(x).all() for x in seeded)}, "
          f"max |difference| {gap:.4f}", flush=True)
    check(all(np.isfinite(x).all() for x in seeded) and gap > 0.05,
          "seeds 1 and 2 give distinct finite scenes")

    # 35. (b) the lattice's flagship precrop probe, 2000 steps fused: K4
    #     and K6 once a step on the tensor cores, the watchdog quiet, the
    #     train PSNR past the background floor + 3 dB; held-out through K3.
    probe = Config(**LATTICE_RECIPE, data_path=lattice_path, allow_synthetic=False,
                   iters=LATTICE_ITERS, resume=False, out_dir=os.path.join(OUT_DIR, "lattice_p1"),
                   ckpt_path=os.path.join(OUT_DIR, "lattice_p1.npz"),
                   metrics_path=os.path.join(OUT_DIR, "lattice_p1.jsonl"))
    if os.path.exists(probe.metrics_path):
        os.unlink(probe.metrics_path)
    reset()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            res = train_mod.main(probe)
    except SystemExit as e:
        print(out.getvalue()[-3000:], flush=True)
        raise RuntimeError(f"check failed: the lattice probe exited {e.code} (the watchdog)")
    text = out.getvalue()
    print("\n".join(line for line in text.splitlines()
                    if line.startswith(("[train] precrop", "[train] sigma-death", "[train] fused",
                                        "[eval]", "[done]"))), flush=True)
    launches = {n: (k.launches, k.mma_launches) for n, k in kernels.items()
                if n in ("K3", "K4", "K6")}
    psnrs = logged_psnrs(probe.metrics_path)
    records = [json.loads(x) for x in open(probe.metrics_path)]
    print(f"[scenes] the lattice's flagship precrop probe (hidden 256, 64 + 128 samples, pool, "
          f"precrop 500 at 0.5, noise decay 2000), {LATTICE_ITERS} steps fused: (launches, on the "
          f"tensor cores) {json.dumps(launches)}; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB "
          f"(bar {LATTICE_MIN_PSNR}); held-out through K3 {res['eval']['psnr_mean']:.2f} dB (the JAX "
          f"package's p1_precrop read {JAX_LATTICE_HELDOUT_2000} dB at step {LATTICE_ITERS}, a TPU "
          f"run); {res['rays_per_sec']:,.0f} rays/s", flush=True)
    check(launches["K4"] == launches["K6"] == (LATTICE_ITERS, LATTICE_ITERS)
          and launches["K3"][0] > 0 and launches["K3"][0] == launches["K3"][1],
          "the lattice probe: K4 and K6 once a step and K3 serving, every launch on the tensor cores")
    check(not any(r.get("sigma_death") for r in records) and psnrs[-1] >= LATTICE_MIN_PSNR,
          f"the lattice probe escapes: no sigma_death record, final train PSNR >= {LATTICE_MIN_PSNR}")
    # 35. (c) a reading: the same recipe without the precrop warmup, the
    #     watchdog tightened (grace 300 steps, 20 log points of 10 steps).
    dead = dataclasses.replace(probe, precrop_iters=0, iters=LATTICE_NO_PRECROP_ITERS,
                               log_every=10, death_grace=300,
                               out_dir=os.path.join(OUT_DIR, "lattice_noprecrop"),
                               ckpt_path=os.path.join(OUT_DIR, "lattice_noprecrop.npz"),
                               metrics_path=os.path.join(OUT_DIR, "lattice_noprecrop.jsonl"))
    if os.path.exists(dead.metrics_path):
        os.unlink(dead.metrics_path)
    rc = 0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            train_mod.main(dead)
    except SystemExit as e:
        rc = e.code
    psnrs = logged_psnrs(dead.metrics_path)
    print(f"[scenes] the same probe without precrop, at most {LATTICE_NO_PRECROP_ITERS} steps "
          f"(watchdog grace 300, window 20 x 10 steps): exit code {rc}, train PSNR {psnrs[0]:.2f} "
          f"-> {psnrs[-1]:.2f} dB over {10 * len(psnrs)} steps (a reading)", flush=True)
    print(f"[scenes] ok in {time.time() - t0:.2f}s", flush=True)


MS_SCENES = 8  # phase 36: BASELINE config 5's scene count (train_multiscene's default)
MS_RAYS = 1024  # rays a scene a step (the driver's default)
MS_EAGER_ITERS = 200  # phase 36 (b): the eager TinyNeRF run
MS_NERF_ITERS = 200  # phase 36 (c): --model nerf at hidden 128
MS_FLAGSHIP_ITERS = 20  # phase 36 (d): --model nerf --hidden 256 --n-fine 128
MS_DP_ITERS = 50  # phase 36 (e): the 2-rank run against world 1
JAX_MS_PSNR = (30.4, 21.7)  # BASELINE.md:201-206: mean (min) PSNR after 10,000 steps (a TPU run)


def _ms_case(kind: str, dev, K: int = MS_SCENES, R: int = MS_RAYS, dtype=torch.bfloat16):
    """K stacked models of a phase 36 shape on the card (scene k from seed
    k) and K scenes' rays, targets and int32 seeds."""
    import numpy as np

    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.models.stacked import stack_models
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
    from tinynerf_tpu_torch.ops.encoding import encoding_dim

    if kind == "tinynerf":
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=128, compute_dtype=dtype)
        make = lambda g: TinyNeRF(cfg, generator=g, device=dev)  # noqa: E731
    else:
        hidden = 256 if kind == "flagship" else 128
        cfg = NeRFConfig(hidden=hidden, compute_dtype=dtype)
        make = lambda g: NeRFMLP(cfg, generator=g, device=dev)  # noqa: E731
    model = stack_models([make(torch.Generator().manual_seed(k)) for k in range(K)])
    rng = np.random.RandomState(36)
    ro = torch.from_numpy((rng.randn(K, R, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32))
    rd = rng.randn(K, R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tgt = torch.from_numpy(rng.rand(K, R, 3).astype(np.float32))
    seeds = torch.arange(101, 101 + K, dtype=torch.int32, device=dev)
    return model, cfg, ro.to(dev), torch.from_numpy(rd).to(dev), tgt.to(dev), seeds


def _union(weights, z_c, n_fine: int):
    """The deterministic fine union of coarse weights and depths (K, R, S)."""
    from tinynerf_tpu_torch.ops.sampling import sample_pdf

    K, R, S = z_c.shape
    z_mids = 0.5 * (z_c[..., 1:] + z_c[..., :-1]).reshape(K * R, S - 1)
    z_f = sample_pdf(z_mids, weights[..., 1:-1].reshape(K * R, S - 2), n_fine, randomized=False)
    return torch.sort(torch.cat([z_c, z_f.reshape(K, R, n_fine)], -1), -1).values.contiguous()


def run_multiscene() -> None:
    """Phase 36: multi-scene training, K2/K4/K6 with a scene axis."""
    import numpy as np

    from tinynerf_tpu_torch import train_multiscene as ms_mod
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6_mod
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4_mod
    from tinynerf_tpu_torch.kernels import fused_train as k2_mod
    from tinynerf_tpu_torch.kernels.fused_render import pack_tiny_weights
    from tinynerf_tpu_torch.models.stacked import scene_module
    from tinynerf_tpu_torch.multiscene import init_multiscene_state, make_multiscene_train_block
    from tinynerf_tpu_torch.ops.rays import get_rays_for_poses
    from tinynerf_tpu_torch.training import TrainSettings, draw_ray_batch, step_generator

    dev = torch.device("cuda", 0)
    card = card_line()
    kernels = _all_kernels()
    k2, k4, k6 = kernels["K2"], kernels["K4"], kernels["K6"]

    def reset():
        for k in kernels.values():
            k.launches = k.mma_launches = 0
            if hasattr(k, "scene_launches"):
                k.scene_launches = 0

    def counts(*names):
        return {n: (kernels[n].launches, kernels[n].mma_launches,
                    getattr(kernels[n], "scene_launches", 0)) for n in names}

    # 36. (a) the scene-axis kernels (fused_train_kernel<kMma, true>,
    #     nerf_walk_scenes_kernel; one-scene launches run the kernels
    #     without scene offsets): HMMA in the tensor-core instantiation
    #     (kMma) only. Then every batched kernel at K = 8 against 8
    #     one-scene launches (bit-identical per scene) and its plain
    #     version (per scene).
    t0 = time.time()
    import re

    from tinynerf_tpu_torch.kernels import _build

    for source, kernel in (("fused_train", r"fused_train_kernelILb([01])ELb1ELb0E"),
                           ("fused_nerf_train", r"nerf_walk_scenes_kernelI.*?Lb([01])ELb0E")):
        hmma = {}
        for fn, n in sass_counts(_build.build(source), "HMMA").items():
            m = re.search(kernel, fn)
            if m:
                hmma[fn] = (m.group(1) == "1", n)
        print(f"[multiscene] (kMma, HMMA instructions) per scene-axis kernel: {json.dumps(hmma)}",
              flush=True)
        check(len(hmma) == 2 and all((n > 0) == mma for mma, n in hmma.values()),
              f"{source}: the scene-axis kernel on the tensor cores holds HMMA instructions, the "
              "CUDA-core one none")
    names_tiny = None
    for dtype in (torch.float32, torch.bfloat16):
        model, cfg, ro, rd, tgt, seeds = _ms_case("tinynerf", dev, dtype=dtype)
        names_tiny = [n for n, _ in model.named_parameters()]
        reset()
        loss, grads = k2_mod.fused_loss_grads_scenes(model, ro, rd, tgt, seeds)
        check(counts("K2")["K2"] == (1, int(dtype == torch.bfloat16), 1),
              "one batched K2 launch for 8 scenes, one scene launch")
        same = True
        for k in range(MS_SCENES):
            l1, g1 = k2_mod.fused_loss_grads(scene_module(model, k), ro[k], rd[k], tgt[k],
                                             int(seeds[k]))
            same = same and float(l1) == float(loss[k]) and all(
                torch.equal(a[k], b) for a, b in zip(grads, g1))
        loss, grads = k2_mod.fused_loss_grads_scenes(model, ro, rd, tgt, seeds, randomized=False)
        want_loss, want = k2_mod.fused_loss_grads_scenes_plain(model, ro, rd, tgt, seeds,
                                                               randomized=False)
        worst = {"loss_rel": 0.0, "min_cosine": 1.0, "mma_scale_err": 0.0, "max_rel_to_leaf": 0.0}
        for k in range(MS_SCENES):
            gk, wk = [g[k] for g in grads], [w[k] for w in want]
            e = leaf_errors(gk, wk)
            worst["loss_rel"] = max(worst["loss_rel"], abs(float(loss[k]) - float(want_loss[k]))
                                    / float(want_loss[k]))
            worst["min_cosine"] = min(worst["min_cosine"], e["min_cosine"])
            worst["max_rel_to_leaf"] = max(worst["max_rel_to_leaf"], e["max_rel_to_leaf"])
            worst["mma_scale_err"] = max(worst["mma_scale_err"],
                                         mma_scale_error(names_tiny, gk, wk))
        ok = (worst["loss_rel"] < 1e-5 and worst["max_rel_to_leaf"] <= 2e-4
              if dtype == torch.float32 else
              worst["loss_rel"] < 1e-3 and worst["min_cosine"] > 0.98
              and worst["mma_scale_err"] < MMA_SCALE)
        print(f"[multiscene] K2 x{MS_SCENES} scenes x {MS_RAYS} rays x 64, hidden 128, "
              f"{str(dtype)[6:]}: each scene bit-identical to its one-scene launch: {same}; "
              f"against the plain version (grid depths), worst over the scenes "
              f"{json.dumps(worst)}", flush=True)
        check(same and ok, f"batched K2 ({dtype}): per scene bit-identical, within the K2 gates")

    def nerf_checks(kind, n_fine):
        model, cfg, ro, rd, tgt, seeds = _ms_case(kind, dev)
        names = [n for n, _ in model.named_parameters()]
        reset()
        loss, grads, w, z = k4_mod.fused_nerf_pass_grads_scenes(
            model, ro, rd, tgt, seeds, n_samples=64, emit_sampling=True, cfg=cfg)
        zu = _union(w, z, n_fine)
        streamed = kind == "flagship"
        if streamed:
            lf, gf = k6_mod.fused_nerf_pass_grads_streamed_scenes(model, ro, rd, tgt, zu, cfg=cfg,
                                                                   sample_block=64)
        else:
            lf, gf = k4_mod.fused_nerf_pass_grads_scenes(model, ro, rd, tgt, seeds, zu,
                                                         randomized=False, cfg=cfg)
        c = counts("K4", "K6")
        n4 = 1 if streamed else 2  # the coarse pass, and the fine one on K4 at hidden 128
        want = {"K4": (n4, n4, n4), "K6": (1, 1, 1) if streamed else (0, 0, 0)}
        check(c == want, f"{kind}: one batched launch a pass for 8 scenes, on the tensor cores")
        same, worst = True, {}
        for k in range(MS_SCENES):
            one = scene_module(model, k)
            l1, g1, w1, z1 = k4_mod.fused_nerf_pass_grads(one, ro[k], rd[k], tgt[k], int(seeds[k]),
                                                          n_samples=64, emit_sampling=True, cfg=cfg)
            jit = k2_mod.jitter_probe(int(seeds[k]), MS_RAYS, 64, 2.0, 6.0, tile=1, device=dev)
            if streamed:
                l2, g2 = k6_mod.fused_nerf_pass_grads_streamed(one, ro[k], rd[k], tgt[k], zu[k],
                                                               cfg=cfg, sample_block=64)
            else:
                l2, g2 = k4_mod.fused_nerf_pass_grads(one, ro[k], rd[k], tgt[k], int(seeds[k]),
                                                      zu[k], randomized=False, cfg=cfg)
            same = same and float(l1) == float(loss[k]) and float(l2) == float(lf[k]) and all(
                torch.equal(a[k], b) for a, b in zip(grads + gf, g1 + g2)) and torch.equal(
                w[k], w1) and torch.equal(z[k], z1) and torch.equal(z[k], jit)
            if k < 2:  # the plain versions on two scenes (each a full autograd pass)
                for tag, lo, gr, fn, args, kw in (
                        ("coarse", loss[k], [g[k] for g in grads], k4_mod.fused_nerf_pass_grads_plain,
                         (one, ro[k], rd[k], tgt[k], 0, z[k]), dict(randomized=False, cfg=cfg)),
                        ("fine", lf[k], [g[k] for g in gf],
                         (k6_mod.fused_nerf_pass_grads_streamed_plain if streamed
                          else k4_mod.fused_nerf_pass_grads_plain),
                         (one, ro[k], rd[k], tgt[k], zu[k]) if streamed
                         else (one, ro[k], rd[k], tgt[k], 0, zu[k]),
                         dict(cfg=cfg, sample_block=64) if streamed
                         else dict(randomized=False, cfg=cfg))):
                    e = pass_errors(lo, gr, fn, args, kw, torch.bfloat16, names)
                    worst[f"{tag}{k}"] = {x: e[x] for x in ("loss_rel", "min_cosine",
                                                            "mma_scale_err", "ok")}
        print(f"[multiscene] {kind} (hidden {cfg.hidden}) x{MS_SCENES} scenes x {MS_RAYS} rays: "
              f"coarse K4 S=64 jittered, fine {'K6' if streamed else 'K4'} on the {64 + n_fine}"
              f"-sample union, bf16, (launches, on the tensor cores, scene launches) "
              f"{json.dumps(c)}; each scene bit-identical to its one-scene launches and its depths "
              f"to jitter_probe(seed k): {same}; against the plain versions (scenes 0, 1) "
              f"{json.dumps(worst)}", flush=True)
        check(same and all(v["ok"] for v in worst.values()),
              f"{kind}: per scene bit-identical, within the NeRF pass gates")
        return model, cfg, ro, rd, tgt, seeds, zu

    nerf_checks("nerf", 64)
    flagship = nerf_checks("flagship", 128)
    print(f"[multiscene] (a) ok in {time.time() - t0:.2f}s", flush=True)

    # 36. (b) train_multiscene's defaults, fused: K2 once a step for all 8
    #     scenes, every scene's train PSNR up >= 3 dB, four K1 previews;
    #     then 200 eager steps whose losses fall.
    t0 = time.time()
    base = dict(out_dir=os.path.join(OUT_DIR, "ms"), ckpt_path=os.path.join(OUT_DIR, "ms.npz"),
                data_dir=os.path.join(OUT_DIR, "ms_data"))
    reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ms_mod.main(ms_mod.MultiSceneConfig(**base))
    text = out.getvalue()
    print("\n".join(l for l in text.splitlines() if not l.startswith("[train] step")
                    or "/2000" in l), flush=True)
    c = counts("K1", "K2")
    rise = [b - a for a, b in zip(res["psnr_first"], res["psnr_last"])]
    print(f"[multiscene] train_multiscene defaults (8 scenes, 400x400, 16 poses, 2000 steps, "
          f"fused): (launches, on the tensor cores, scene launches) {json.dumps(c)}; per-scene "
          f"train PSNR {np.round(res['psnr_first'], 2).tolist()} -> "
          f"{np.round(res['psnr_last'], 2).tolist()} (rise min {min(rise):.2f} dB); mean "
          f"{res['psnr_mean']:.2f}, min {res['psnr_min']:.2f} dB; {res['rays_per_sec']:,.0f} rays/s "
          f"aggregate", flush=True)
    check(c["K2"] == (2000, 2000, 2000), "K2 once a step for all 8 scenes, on the tensor cores")
    check(c["K1"][0] > 0 and c["K1"][0] == c["K1"][1], "the previews through K1, tensor cores")
    check(min(rise) >= 3.0, "every scene's train PSNR rises >= 3 dB")
    check(sorted(os.listdir(base["out_dir"]))[:4] == [f"scene_{k:03d}.png" for k in range(4)],
          "four previews written")
    with np.load(base["ckpt_path"]) as zf:
        meta = json.loads(str(zf["meta"]))
        check(zf["opt_0"].shape == (MS_SCENES,) and meta["meta"]["model"] == "tinynerf-multiscene",
              "the batched checkpoint: (8,) count, the multiscene meta")
    reset()
    eager = dict(base, out_dir=os.path.join(OUT_DIR, "ms_eager"),
                 ckpt_path=os.path.join(OUT_DIR, "ms_eager.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        res_e = ms_mod.main(ms_mod.MultiSceneConfig(**eager, iters=MS_EAGER_ITERS, log_every=50,
                                                    fused_train=False, preview=False))
    print(f"[multiscene] eager, {MS_EAGER_ITERS} steps: per-scene train PSNR "
          f"{np.round(res_e['psnr_first'], 2).tolist()} -> "
          f"{np.round(res_e['psnr_last'], 2).tolist()}; K2 launches {counts('K2')['K2']}; "
          f"{res_e['rays_per_sec']:,.0f} rays/s aggregate", flush=True)
    check(counts("K2")["K2"][0] == 0 and res_e["psnr_mean"] > float(np.mean(res_e["psnr_first"])),
          "the eager run launches no K2 and its loss falls")
    print(f"[multiscene] (b) ok in {time.time() - t0:.2f}s", flush=True)

    # 36. (c) --model nerf at hidden 128, 200 steps: K4 twice a step; (d) the
    #     flagship widths, 20 steps: K4 + K6 once each a step.
    t0 = time.time()
    for tag, iters, kw, want in (
            ("nerf", MS_NERF_ITERS, {}, {"K4": (400, 400, 400), "K6": (0, 0, 0)}),
            ("flagship", MS_FLAGSHIP_ITERS, dict(hidden=256, n_fine=128),
             {"K4": (20, 20, 20), "K6": (20, 20, 20)})):
        reset()
        cfg_n = dict(base, out_dir=os.path.join(OUT_DIR, f"ms_{tag}"),
                     ckpt_path=os.path.join(OUT_DIR, f"ms_{tag}.npz"))
        with contextlib.redirect_stdout(io.StringIO()):
            r = ms_mod.main(ms_mod.MultiSceneConfig(**cfg_n, model="nerf", iters=iters,
                                                    log_every=min(50, iters), **kw))
        c = counts("K3", "K4", "K5", "K6")
        rise = float(np.mean(r["psnr_last"]) - np.mean(r["psnr_first"]))
        print(f"[multiscene] --model nerf {kw or '(hidden 128, n_fine 64)'}, {iters} steps: "
              f"(launches, on the tensor cores, scene launches) {json.dumps(c)}; mean train PSNR "
              f"{np.mean(r['psnr_first']):.2f} -> {r['psnr_mean']:.2f} dB (rise {rise:.2f}); "
              f"{r['rays_per_sec']:,.0f} rays/s aggregate", flush=True)
        check(all(c[n] == want[n] for n in want), f"{tag}: one batched launch a pass a step")
        check(c["K3"][0] > 0 and c["K3"][0] == c["K3"][1], f"{tag}: previews through K3")
        if tag == "nerf":
            check(rise >= 2.0, "--model nerf: mean train PSNR rises >= 2 dB")
    print(f"[multiscene] (c, d) ok in {time.time() - t0:.2f}s", flush=True)

    # 36. (e) two ranks sharing the card, 8 scenes, 50 steps: every scene's
    #     parameters bit-identical to a world-1 run.
    t0 = time.time()
    dp = dict(base, iters=MS_DP_ITERS, log_every=25, preview=False)
    with contextlib.redirect_stdout(io.StringIO()):
        ms_mod.main(ms_mod.MultiSceneConfig(**{**dp, "ckpt_path": os.path.join(OUT_DIR, "ms_w1.npz")}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "tinynerf_tpu_torch.train_multiscene", "--iters", str(MS_DP_ITERS),
           "--log-every", "25", "--no-preview", "--data-dir", base["data_dir"],
           "--out-dir", os.path.join(OUT_DIR, "ms_w2"),
           "--ckpt-path", os.path.join(OUT_DIR, "ms_w2.npz")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": os.getcwd()})
    with open(os.path.join(OUT_DIR, "ms_w2.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    print("\n".join(l for l in (proc.stdout + proc.stderr).splitlines()
                    if l.startswith(("[mesh]", "[distributed]", "[done]")) or "Error" in l),
          flush=True)
    check(proc.returncode == 0, f"the 2-rank run exits 0 (rc {proc.returncode})")
    with np.load(os.path.join(OUT_DIR, "ms_w1.npz")) as a, \
            np.load(os.path.join(OUT_DIR, "ms_w2.npz")) as b:
        keys = [k for k in a.files if k.startswith(("param_", "opt_"))]
        same = sorted(keys) == sorted(k for k in b.files if k.startswith(("param_", "opt_"))) \
            and all(np.array_equal(a[k], b[k]) for k in keys)
    print(f"[multiscene] 2 ranks sharing the card (gloo), {MS_DP_ITERS} steps: every scene's "
          f"parameters and Adam state bit-identical to world 1: {same} ({len(keys)} leaves)",
          flush=True)
    check(same, "2 ranks: per-scene parameters bit-identical to world 1")
    print(f"[multiscene] (e) ok in {time.time() - t0:.2f}s", flush=True)

    # 36. (f) timing, plain, kernel, kernel, plain; the batched launch
    #     against 8 one-scene launches; the loop; the per-step host work.
    t0 = time.time()
    times = {}

    def turns(tag, fns):
        for name in ("plain", "kernel", "singles", "kernel", "singles", "plain"):
            times.setdefault(tag, {}).setdefault(name, []).append(
                cuda_ms(fns[name], iters=3 if name == "plain" else 10))

    model, cfg, ro, rd, tgt, seeds = _ms_case("tinynerf", dev)
    singles = [scene_module(model, k) for k in range(MS_SCENES)]
    turns("K2", {
        "kernel": lambda: k2_mod.fused_loss_grads_scenes(model, ro, rd, tgt, seeds),
        "singles": lambda: [k2_mod.fused_loss_grads(singles[k], ro[k], rd[k], tgt[k], seeds[k:k + 1])
                            for k in range(MS_SCENES)],
        "plain": lambda: k2_mod.fused_loss_grads_scenes_plain(model, ro, rd, tgt, seeds)})
    n_par = sum(p[0].numel() for p in model.parameters())
    bounds = {"K2": (2 * MS_SCENES * MS_RAYS * 64 * train_macs_per_point(singles[0]),
                     4 * MS_SCENES * (MS_RAYS * 9 + 2 * n_par + 1))}
    pack_ms = min(cuda_ms(lambda: pack_tiny_weights(model, model.cfg, mma=True, upstream=True))
                  for _ in range(2))
    for kind in ("nerf", "flagship"):
        model, cfg, ro, rd, tgt, seeds = _ms_case(kind, dev)
        singles = [scene_module(model, k) for k in range(MS_SCENES)]
        n_par = sum(p[0].numel() for p in model.parameters())
        w, z = k4_mod.fused_nerf_pass_grads_scenes(model, ro, rd, tgt, seeds, emit_sampling=True,
                                                   cfg=cfg)[2:]
        n_fine = 128 if kind == "flagship" else 64
        zu = _union(w, z, n_fine)
        macs = train_macs_per_point(singles[0])
        tag = "K4 coarse " + kind
        turns(tag, {
            "kernel": lambda: k4_mod.fused_nerf_pass_grads_scenes(model, ro, rd, tgt, seeds,
                                                                  emit_sampling=True, cfg=cfg),
            "singles": lambda: [k4_mod.fused_nerf_pass_grads(
                singles[k], ro[k], rd[k], tgt[k], seeds[k:k + 1], emit_sampling=True, cfg=cfg)
                for k in range(MS_SCENES)],
            "plain": lambda: k4_mod.fused_nerf_pass_grads_scenes_plain(
                model, ro, rd, tgt, seeds, z, randomized=False, cfg=cfg)})
        bounds[tag] = (2 * MS_SCENES * MS_RAYS * 64 * macs,
                       4 * MS_SCENES * (MS_RAYS * (9 + 2 * 64) + 2 * n_par + 1))
        S = 64 + n_fine
        if kind == "flagship":
            tag = "K6 fine flagship"
            turns(tag, {
                "kernel": lambda: k6_mod.fused_nerf_pass_grads_streamed_scenes(
                    model, ro, rd, tgt, zu, cfg=cfg, sample_block=64),
                "singles": lambda: [k6_mod.fused_nerf_pass_grads_streamed(
                    singles[k], ro[k], rd[k], tgt[k], zu[k], cfg=cfg, sample_block=64)
                    for k in range(MS_SCENES)],
                "plain": lambda: k6_mod.fused_nerf_pass_grads_streamed_scenes_plain(
                    model, ro, rd, tgt, zu, cfg=cfg, sample_block=64)})
        else:
            tag = "K4 fine nerf"
            turns(tag, {
                "kernel": lambda: k4_mod.fused_nerf_pass_grads_scenes(
                    model, ro, rd, tgt, seeds, zu, randomized=False, cfg=cfg),
                "singles": lambda: [k4_mod.fused_nerf_pass_grads(
                    singles[k], ro[k], rd[k], tgt[k], seeds[k:k + 1], zu[k], randomized=False,
                    cfg=cfg) for k in range(MS_SCENES)],
                "plain": lambda: k4_mod.fused_nerf_pass_grads_scenes_plain(
                    model, ro, rd, tgt, seeds, zu, randomized=False, cfg=cfg)})
        bounds[tag] = (2 * MS_SCENES * MS_RAYS * S * macs,
                       4 * MS_SCENES * (MS_RAYS * (6 + 2 * S) + 2 * n_par + 1))
    # The flagship K6 launch's device buffers at K = 8: the walk's workspace
    # and the partial rows, from the wrapper's own sizes; the peak memory.
    lib = k4_mod._lib()
    fcfg = flagship[1]
    ws_floats = lib.tinynerf_fused_nerf_train_workspace_floats(2, 64, 10, 256, 8, 64, 0)
    n_grad = k4_mod.pack_nerf_weights(scene_module(flagship[0], 0), fcfg).numel()
    n_blocks = min(MS_RAYS // 2, torch.cuda.get_device_properties(dev).multi_processor_count)
    buf = {"workspace_MB": 4 * MS_SCENES * n_blocks * ws_floats / 1e6,
           "partials_MB": 4 * MS_SCENES * n_blocks * (n_grad + 1) / 1e6}
    torch.cuda.reset_peak_memory_stats(dev)
    k6_mod.fused_nerf_pass_grads_streamed_scenes(*flagship[:1], *flagship[2:5], flagship[6],
                                                 cfg=fcfg, sample_block=64)
    torch.cuda.synchronize()
    buf["peak_allocated_MB"] = torch.cuda.max_memory_allocated(dev) / 1e6
    ms = {t: {n: min(v) for n, v in d.items()} for t, d in times.items()}
    for tag, d in ms.items():
        flops, nbytes = bounds[tag]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        print(f"[timing] {card}: {tag}, {MS_SCENES} scenes x {MS_RAYS} rays, bf16: batched "
              f"{d['kernel']:.4f} ms, {MS_SCENES} one-scene launches {d['singles']:.4f} ms, plain "
              f"{d['plain']:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB) (all runs {json.dumps(times[tag])})", flush=True)
    print(f"[timing] {card}: the flagship K6 launch at K = {MS_SCENES}: {json.dumps(buf)}",
          flush=True)
    # The 8-scene loop, fused against eager, and its per-step host work.
    data = ms_mod._load_or_make_scene
    cfg0 = ms_mod.MultiSceneConfig(**base)
    scenes = [data(cfg0, k, dev) for k in range(MS_SCENES)]
    poses = torch.from_numpy(np.stack([s["poses"] for s in scenes])).to(dev)
    images = torch.from_numpy(np.stack([s["images"] for s in scenes])).to(dev)
    H = cfg0.size
    rays = [get_rays_for_poses(H, H, float(scenes[0]["focal"]), p) for p in poses]
    rays_o = torch.stack([r[0] for r in rays])
    rays_d = torch.stack([r[1] for r in rays])
    pixels = images.reshape(MS_SCENES, cfg0.poses_per_scene, H * H, 3)
    s = TrainSettings(n_rand=MS_RAYS)
    sps = {}
    for name in ("eager", "fused", "fused", "eager"):
        gf = k2_mod.make_fused_grad_fn_scenes(s) if name == "fused" else None
        m, o = init_multiscene_state(0, MS_SCENES, s, device=dev)
        block = make_multiscene_train_block(s, TIMED_STEPS, MS_SCENES, grad_fn=gf)
        block(m, o, 1, 0, rays_o, rays_d, pixels)
        torch.cuda.synchronize()
        t1 = time.time()
        block(m, o, 1, TIMED_STEPS, rays_o, rays_d, pixels)
        torch.cuda.synchronize()
        sps.setdefault(name, []).append(TIMED_STEPS / (time.time() - t1))

    def draws():
        gens = [step_generator(k, 7, dev) for k in range(MS_SCENES)]
        b = [draw_ray_batch(s, g, 7, rays_o[k], rays_d[k], pixels[k]) for k, g in enumerate(gens)]
        seeds_ = [torch.randint(0, 2**31 - 1, (1,), generator=g, dtype=torch.int32, device=dev)
                  for g in gens]
        return [torch.stack(t) for t in zip(*b)], torch.cat(seeds_)

    draw_ms = min(cuda_ms(draws) for _ in range(2))
    best = {k: max(v) for k, v in sps.items()}
    agg = MS_SCENES * MS_RAYS
    print(f"[timing] {card}: the {MS_SCENES}-scene TinyNeRF loop, {TIMED_STEPS} steps of "
          f"{MS_SCENES} x {MS_RAYS} rays, bf16: fused {best['fused']:.2f} steps/s "
          f"({best['fused'] * agg:,.0f} rays/s aggregate), eager {best['eager']:.2f} steps/s "
          f"({best['eager'] * agg:,.0f}) (all runs {json.dumps(sps)}); per-step host work "
          f"(readings): the {MS_SCENES} scenes' draws and seeds {draw_ms:.4f} ms, the batched "
          f"weight pack {pack_ms:.4f} ms", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)


FULL_WIDTH = dict(hidden=256, depth=8, skip_at=4)  # phase 37: the NeRF paper's trunk as a TinyNeRF
FULL_ITERS = 500  # phase 37 (e): the full-width train, fused and eager
ANY_SHAPE_ITERS = 200  # phase 37 (f): train --hidden 36 --n-samples 20 (F4a, F4b)
WIDE_ITERS = 20  # phase 37 (f): train --hidden 264 --n-samples 192 (spill, K1 in segments)
# phase 37 (a): K2 at every F4 shape, (tag, hidden, depth, skip_at, S), 2048 rays
F4_K2 = (("F4a S=20", 128, 4, 2, 20), ("F4b hidden 36", 36, 4, 2, 64),
         ("F4c hidden 168", 168, 4, 2, 64), ("F4c hidden 256", 256, 4, 2, 64),
         ("F4c depth 6", 128, 6, 3, 64), ("F4c S=96", 128, 4, 2, 96),
         ("F4c S=128", 128, 4, 2, 128), ("F4c 8 x 256", 256, 8, 4, 64),
         ("F4c hidden 264, S=192", 264, 4, 2, 192))
# phase 37 (b): K1 at the F4b and F4d shapes and the full width, (tag, hidden, depth, skip_at, S, rays)
F4_K1 = (("F4b hidden 36", 36, 4, 2, 64, 8192), ("F4d hidden 264", 264, 4, 2, 64, 8192),
         ("F4d hidden 264, S=192", 264, 4, 2, 192, 4096),
         ("F4d S=192 hidden 256", 256, 4, 2, 192, 4096), ("F4d S=512", 128, 4, 2, 512, 2048),
         ("full width", 256, 8, 4, 64, 8192))


def _tiny_case(hidden, depth, skip_at, dtype, dev, n_rays, seed=0):
    """A TinyNeRF of the given trunk (seeded) and n_rays rays toward the
    scene with random targets."""
    import numpy as np

    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
    from tinynerf_tpu_torch.ops.encoding import encoding_dim

    cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=hidden, depth=depth, skip_at=skip_at,
                         compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    rng = np.random.RandomState(37 + seed)
    ro = torch.from_numpy((rng.randn(n_rays, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32))
    rd = rng.randn(n_rays, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[:, 2] = -np.abs(rd[:, 2])  # toward the origin
    tgt = torch.from_numpy(rng.rand(n_rays, 3).astype(np.float32))
    return model, cfg, ro.to(dev), torch.from_numpy(rd).to(dev), tgt.to(dev)


def k2_gates(dtype, loss, grads, want_loss, want, names) -> tuple:
    """K2's gates (PERF.md section 2) -> (errors, ok)."""
    err = {"loss_rel": abs(float(loss) - float(want_loss)) / float(want_loss),
           **leaf_errors(grads, want), "mma_scale_err": mma_scale_error(names, grads, want)}
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    if dtype == torch.float32:
        ok = err["loss_rel"] < 1e-5 and err["max_rel_to_leaf"] <= 2e-4
    else:
        ok = err["loss_rel"] < 1e-3 and err["min_cosine"] > 0.98 and err["mma_scale_err"] < MMA_SCALE
    return err, ok and finite


def run_tiny_domain(build_render, build_train) -> list:
    """Phase 37: K1 and K2 at every TinyNeRF shape the JAX kernels take (F4:
    any batch, any width, the spill route, K1 in rounds and segments), the
    scene axis at widths off multiples of 8 (F5), and the full-width
    TinyNeRF (8 x 256, skip at 4) trained through the spill route."""
    import numpy as np

    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch import train_multiscene as ms_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6_mod
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4_mod
    from tinynerf_tpu_torch.kernels import fused_render as k1_mod
    from tinynerf_tpu_torch.kernels import fused_train as k2_mod
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.models.stacked import stack_models

    dev = torch.device("cuda", 0)
    card = card_line()
    k1, k2 = k1_mod.fused_render_rays, k2_mod.fused_loss_grads
    k4, k6 = k4_mod.fused_nerf_pass_grads, k6_mod.fused_nerf_pass_grads_streamed
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene

    def reset():
        k1.launches = k1.mma_launches = k1.general_launches = 0
        k2.launches = k2.mma_launches = k2.spill_launches = k2.scene_launches = 0
        for k in (k4, k6):
            k.launches = k.mma_launches = k.scene_launches = 0

    # 37. HMMA in the spill route's tensor-core instantiations only.
    t0 = time.time()
    import re

    hmma = {fn: n for fn, n in sass_counts(build_train.result()[0], "HMMA").items()
            if re.search(r"fused_train_kernelILb[01]ELb[01]ELb1E", fn)}
    print(f"[tiny] HMMA instructions per spill kernel (kSpill, cuobjdump -sass): "
          f"{json.dumps(hmma)}", flush=True)
    check(len(hmma) == 4 and all((n > 0) == ("kernelILb1E" in fn) for fn, n in hmma.items()),
          "the spill route's kMma instantiations hold HMMA instructions, the others none")
    build_render.result()

    # 37. (a) K2 at every F4 shape, f32 and bf16, against its plain version
    #     (grid depths) under the K2 gates; every launch on its configured
    #     route, none refused.
    errs = {}
    for tag, hidden, depth, skip_at, S in F4_K2:
        for dtype in (torch.float32, torch.bfloat16):
            model, cfg, ro, rd, tgt = _tiny_case(hidden, depth, skip_at, dtype, dev, N_RAYS_TRAIN)
            kw = dict(n_samples=S, randomized=False, model_cfg=cfg)
            reset()
            loss, grads = k2(model, ro, rd, tgt, 0, **kw)
            torch.cuda.synchronize()
            route = (k2.launches, k2.mma_launches, k2.spill_launches)
            want_loss, want = k2_mod.fused_loss_grads_plain(model, ro, rd, tgt, 0, **kw)
            names = [n for n, _ in model.named_parameters()]
            err, ok = k2_gates(dtype, loss, grads, want_loss, want, names)
            errs[tag, dtype] = err
            print(f"[tiny] K2 {tag} ({k2_mod.k2_route(cfg, S)}), {str(dtype)[6:]}: (launches, "
                  f"tensor cores, spill) {route}; {json.dumps(err)}", flush=True)
            want_route = (1, int(k2_mod.k2_uses_tensor_cores(
                dataclasses.replace(cfg, hidden=-(-hidden // 8) * 8), S)),
                int(not k2_mod.k2_fits_shared_memory(cfg, S)))
            check(route == want_route and ok and route[2] == int(tag.startswith("F4c")),
                  f"K2 {tag} {dtype}: one launch on its route (F4c: spill), within the K2 gates")

    # 37. (b) the spill route forced at the recipe's shape (and at hidden 36,
    #     CUDA cores): bit-identical to the shared route, jittered, with noise.
    for hidden, dtype in ((128, torch.float32), (128, torch.bfloat16), (36, torch.bfloat16)):
        model, cfg, ro, rd, tgt = _tiny_case(hidden, 4, 2, dtype, dev, N_RAYS_TRAIN)
        noise = torch.randn(N_RAYS_TRAIN, 64, generator=torch.Generator().manual_seed(5)).to(dev)
        runs = [k2(model, ro, rd, tgt, 9, sigma_noise=noise, spill=spill) for spill in (False, True)]
        same = float(runs[0][0]) == float(runs[1][0]) and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        print(f"[tiny] K2 hidden {hidden} {str(dtype)[6:]}: the spill route bit-identical to the "
              f"shared route: {same}", flush=True)
        check(same, f"K2 spill == shared at hidden {hidden}, {dtype}")

    # 37. (c) K1 at the F4b and F4d shapes and the full width, f32 and bf16,
    #     against its plain version under the render gates.
    with torch.no_grad():
        for tag, hidden, depth, skip_at, S, n_rays in F4_K1:
            for dtype in (torch.float32, torch.bfloat16):
                model, cfg, ro, rd, _ = _tiny_case(hidden, depth, skip_at, dtype, dev, n_rays)
                reset()
                got = k1(model, ro, rd, n_samples=S, model_cfg=cfg)
                torch.cuda.synchronize()
                route = (k1.launches, k1.mma_launches, k1.general_launches)
                want = k1_mod.fused_render_rays_plain(model, ro, rd, n_samples=S, model_cfg=cfg)
                errs["K1", tag, dtype] = err = ray_errors(got, want)
                shape = k1_mod.k1_shape(dataclasses.replace(cfg, hidden=-(-hidden // 8) * 8), S)
                mma, general = shape[:2]
                print(f"[tiny] K1 {tag} (k1_shape: tensor cores, general, tile rays, segment "
                      f"samples {shape}), {str(dtype)[6:]}: (launches, tensor cores, general) "
                      f"{route}; {json.dumps(err)}", flush=True)
                check(route == (1, int(mma), int(general)) and within(err, dtype)
                      and bool(torch.isfinite(got).all()),
                      f"K1 {tag} {dtype}: one launch on its route, within the render gates")

    # 37. (d) the scene axis at widths off multiples of 8: K2 (hidden 36, and
    #     the full width on the spill route), K4 and K6 (hidden 36, rgb_hidden
    #     20) for 3 scenes, each bit-identical to its one-scene launch.
    K = 3
    for tag, hidden, depth, skip_at, S in (("hidden 36", 36, 4, 2, 20),
                                           ("full width", 256, 8, 4, 64)):
        cases = [_tiny_case(hidden, depth, skip_at, torch.bfloat16, dev, 1000, seed=k)
                 for k in range(K)]
        model = stack_models([c[0] for c in cases])
        ro, rd, tgt = (torch.stack([c[i] for c in cases]) for i in (2, 3, 4))
        seeds = torch.arange(7, 7 + K, dtype=torch.int32, device=dev)
        reset()
        loss, grads = k2_mod.fused_loss_grads_scenes(model, ro, rd, tgt, seeds, n_samples=S)
        batched = (k2.launches, k2.scene_launches)
        same = True
        for k in range(K):
            l1, g1 = k2(cases[k][0], ro[k], rd[k], tgt[k], seeds[k:k + 1], n_samples=S)
            same = same and float(l1) == float(loss[k]) and all(
                torch.equal(a[k], b) for a, b in zip(grads, g1))
        print(f"[tiny] K2 x{K} scenes, {tag}, 1000 rays x {S} (padded to whole tiles), bf16 "
              f"({k2_mod.k2_route(cases[0][1], S)}): each scene bit-identical to its one-scene "
              f"launch: {same}", flush=True)
        check(same and batched == (1, 1), f"batched K2 at {tag}: one launch, per scene identical")
    ncfg = NeRFConfig(hidden=36, rgb_hidden=20, compute_dtype=torch.bfloat16)
    mlps = [NeRFMLP(ncfg, generator=torch.Generator().manual_seed(k), device=dev) for k in range(K)]
    model = stack_models(mlps)
    _, _, ro, rd, tgt = _tiny_case(128, 4, 2, torch.float32, dev, K * 512)
    ro, rd, tgt = (x.reshape(K, 512, 3) for x in (ro, rd, tgt))
    seeds = torch.arange(3, 3 + K, dtype=torch.int32, device=dev)
    reset()
    loss, grads, w, z = k4_mod.fused_nerf_pass_grads_scenes(model, ro, rd, tgt, seeds,
                                                            emit_sampling=True, cfg=ncfg)
    zu = _union(w, z, 128)
    loss6, grads6 = k6_mod.fused_nerf_pass_grads_streamed_scenes(model, ro, rd, tgt, zu, cfg=ncfg,
                                                                sample_block=64)
    same4 = same6 = True
    for k in range(K):
        l1, g1, w1, z1 = k4(mlps[k], ro[k], rd[k], tgt[k], seeds[k:k + 1], emit_sampling=True,
                            cfg=ncfg)
        same4 = same4 and float(l1) == float(loss[k]) and torch.equal(w1, w[k]) and all(
            torch.equal(a[k], b) for a, b in zip(grads, g1))
        l6, g6 = k6(mlps[k], ro[k], rd[k], tgt[k], zu[k], cfg=ncfg, sample_block=64)
        same6 = same6 and float(l6) == float(loss6[k]) and all(
            torch.equal(a[k], b) for a, b in zip(grads6, g6))
    print(f"[tiny] K4 and K6 x{K} scenes at hidden 36, rgb_hidden 20 (padded to 40, 24), bf16: "
          f"each scene bit-identical to its one-scene launch: K4 {same4}, K6 {same6}; "
          f"(launches, tensor cores, scene launches) K4 {(k4.launches, k4.mma_launches, k4.scene_launches)}"
          f", K6 {(k6.launches, k6.mma_launches, k6.scene_launches)}", flush=True)
    check(same4 and same6, "batched K4/K6 at widths off 8: per scene bit-identical")
    print(f"[tiny] (a-d) ok in {time.time() - t0:.2f}s", flush=True)

    # 37. (e) the slice: python -m tinynerf_tpu_torch.train --hidden 256
    #     --depth 8 --skip-at 4, fused (K2 on the spill route and the tensor
    #     cores every step, K1 on the tensor cores) and eager, 500 steps each.
    t0 = time.time()
    runs = {}
    for fused in (True, False):
        name = "fused" if fused else "eager"
        cfg = Config(data_path=data_path, out_dir=os.path.join(OUT_DIR, f"full_{name}"),
                     iters=FULL_ITERS, holdout=4, resume=False, log_every=50,
                     ckpt_path=os.path.join(OUT_DIR, f"full_{name}.npz"),
                     metrics_path=os.path.join(OUT_DIR, f"full_{name}.jsonl"),
                     fused_train=fused, fused=fused, **FULL_WIDTH)
        if os.path.exists(cfg.metrics_path):
            os.unlink(cfg.metrics_path)
        reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train_mod.main(cfg)
        lines = [l for l in out.getvalue().splitlines() if "route" in l]
        c = {"K2": (k2.launches, k2.mma_launches, k2.spill_launches),
             "K1": (k1.launches, k1.mma_launches, k1.general_launches)}
        psnrs = logged_psnrs(cfg.metrics_path)
        rise = sum(psnrs[-3:]) / 3 - psnrs[0]
        runs[name] = {"counts": c, "rise": rise, "heldout": res["eval"]["psnr_mean"],
                      "rays_per_sec": res["rays_per_sec"]}
        print(f"[tiny] full width {name}: {lines}; (launches, tensor cores, spill or general) "
              f"{json.dumps(c)}; train PSNR {psnrs[0]:.2f} -> {sum(psnrs[-3:]) / 3:.2f} dB (rise "
              f"{rise:.2f}), held-out {res['eval']['psnr_mean']:.2f} dB, "
              f"{res['rays_per_sec']:,.0f} rays/s", flush=True)
        check(rise >= 3.0, f"full width {name}: train PSNR rises >= 3 dB")
    check(runs["fused"]["counts"]["K2"] == (FULL_ITERS,) * 3,
          "full width: every step one K2 launch, on the spill route and the tensor cores")
    k1c = runs["fused"]["counts"]["K1"]
    check(k1c[0] > 0 and k1c[0] == k1c[1] and k1c[2] == 0, "full width: K1 on the tensor cores")
    check(runs["eager"]["counts"]["K2"][0] == 0 and runs["eager"]["counts"]["K1"][0] == 0,
          "the eager run launches no K1, K2")
    gap = abs(runs["fused"]["heldout"] - runs["eager"]["heldout"])
    print(f"[tiny] full width: held-out PSNR fused vs eager {gap:.3f} dB apart", flush=True)
    check(gap <= 1.5, "full width: fused and eager held-out within 1.5 dB")

    # 37. (f) any shape through the trainer: --hidden 36 --n-samples 20 (2048
    #     rays, tiles of 3: padded; hidden padded to 40), --hidden 264
    #     --n-samples 192 (K2 spill on the CUDA cores, K1 in rounds and
    #     segments), and train_multiscene --hidden 36 (the batched K2).
    shapes = {}
    for tag, kw, iters in (("hidden 36, S=20", dict(hidden=36, n_samples=20), ANY_SHAPE_ITERS),
                           ("hidden 264, S=192", dict(hidden=264, n_samples=192), WIDE_ITERS)):
        cfg = Config(data_path=data_path, out_dir=os.path.join(OUT_DIR, "any_shape"), iters=iters,
                     holdout=4, resume=False, log_every=10,
                     ckpt_path=os.path.join(OUT_DIR, "any_shape.npz"),
                     metrics_path=os.path.join(OUT_DIR, "any_shape.jsonl"), **kw)
        if os.path.exists(cfg.metrics_path):
            os.unlink(cfg.metrics_path)
        reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train_mod.main(cfg)
        psnrs = logged_psnrs(cfg.metrics_path)
        c = shapes[tag] = {"K2": (k2.launches, k2.mma_launches, k2.spill_launches),
                           "K1": (k1.launches, k1.mma_launches, k1.general_launches)}
        lines = [l for l in out.getvalue().splitlines() if "route" in l]
        print(f"[tiny] train {tag}, {iters} steps: {lines}; (launches, tensor cores, spill or "
              f"general) {json.dumps(c)}; train PSNR {psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB, "
              f"held-out {res['eval']['psnr_mean']:.2f} dB", flush=True)
        check(c["K2"][0] == iters and c["K1"][0] > 0 and np.isfinite(res["eval"]["psnr_mean"])
              and psnrs[-1] > psnrs[0], f"train {tag}: K2 every step, K1 renders, PSNR rises")
    check(shapes["hidden 264, S=192"]["K2"][2] == WIDE_ITERS
          and shapes["hidden 264, S=192"]["K1"][2] == shapes["hidden 264, S=192"]["K1"][0],
          "hidden 264, S=192: K2 on the spill route, K1 in segments")
    reset()
    with contextlib.redirect_stdout(io.StringIO()):
        r = ms_mod.main(ms_mod.MultiSceneConfig(  # phase 36's scenes 0-3
            scenes=4, iters=20, log_every=10, hidden=36, data_dir=os.path.join(OUT_DIR, "ms_data"),
            out_dir=os.path.join(OUT_DIR, "ms_tiny"), ckpt_path=os.path.join(OUT_DIR, "ms_tiny.npz"),
            preview=False))
    print(f"[tiny] train_multiscene --hidden 36, 4 scenes, 20 steps: K2 (launches, scene "
          f"launches) {(k2.launches, k2.scene_launches)}; mean train PSNR {r['psnr_mean']:.2f} dB",
          flush=True)
    check(k2.launches == 20 and k2.scene_launches == 20 and np.isfinite(r["psnr_mean"]),
          "train_multiscene at hidden 36: one batched K2 launch a step")
    print(f"[tiny] (e, f) ok in {time.time() - t0:.2f}s", flush=True)

    # 37. (g) timing: plain, kernel, kernel, plain. K2: the recipe's shape on
    #     the shared and the spill routes, the full width (spill, tensor
    #     cores), hidden 264 at S=192 (spill, CUDA cores); K1: the full width
    #     (tensor cores) and S=192 at hidden 264 (rounds, segments).
    t0 = time.time()
    times, bounds, launch_counts = {}, {}, {}
    full = runs["fused"]["counts"]
    wide = shapes["hidden 264, S=192"]
    k2_cases = (("K2 recipe, shared", 128, 4, 2, 64, False, None),
                ("K2 recipe, spill", 128, 4, 2, 64, True, None),
                ("K2 full width, spill, tensor cores", 256, 8, 4, 64, None, full["K2"][0]),
                ("K2 hidden 264, S=192, spill, CUDA cores", 264, 4, 2, 192, None, wide["K2"][0]))
    for tag, hidden, depth, skip_at, S, spill, n in k2_cases:
        model, cfg, ro, rd, tgt = _tiny_case(hidden, depth, skip_at, torch.bfloat16, dev,
                                             N_RAYS_TRAIN)
        seed = torch.tensor([3], dtype=torch.int32, device=dev)
        fns = {"kernel": lambda: k2(model, ro, rd, tgt, seed, n_samples=S, spill=spill),
               "plain": lambda: k2_mod.fused_loss_grads_plain(model, ro, rd, tgt, 3, n_samples=S)}
        for name in ("plain", "kernel", "kernel", "plain"):
            times.setdefault(tag, {}).setdefault(name, []).append(
                cuda_ms(fns[name], iters=5 if S > 64 else 20))
        n_par = sum(p.numel() for p in model.parameters())
        bounds[tag] = (2 * N_RAYS_TRAIN * S * train_macs_per_point(model),
                       4 * (N_RAYS_TRAIN * 9 + 2 * n_par + 1))
        launch_counts[tag] = n
    # The spill launch's device buffers at the full width: the workspace and
    # the partial rows, from the wrapper's own sizes.
    lib = k2_mod._lib()
    n_blocks = min(N_RAYS_TRAIN, torch.cuda.get_device_properties(dev).multi_processor_count)
    model = _tiny_case(256, 8, 4, torch.bfloat16, dev, 8)[0]
    n_grad = k1_mod.pack_tiny_weights(model, model.cfg)[0].numel()
    buf = {"workspace_MB": 4 * n_blocks * lib.tinynerf_fused_train_workspace_floats(
               1, 64, 10, 256, 8, 4, 1) / 1e6,
           "partials_MB": 4 * n_blocks * k2_mod.partial_row(n_grad) / 1e6}
    with torch.no_grad():
        for tag, hidden, depth, skip_at, S, n_rays, n in (
                ("K1 full width, tensor cores", 256, 8, 4, 64, 8192, full["K1"][0]),
                ("K1 hidden 264, S=192, rounds and segments", 264, 4, 2, 192, 4096, wide["K1"][0])):
            model, cfg, ro, rd, _ = _tiny_case(hidden, depth, skip_at, torch.bfloat16, dev, n_rays)
            fns = {"kernel": lambda: k1(model, ro, rd, n_samples=S),
                   "plain": lambda: k1_mod.fused_render_rays_plain(model, ro, rd, n_samples=S)}
            for name in ("plain", "kernel", "kernel", "plain"):
                times.setdefault(tag, {}).setdefault(name, []).append(cuda_ms(fns[name], iters=5))
            n_par = sum(p.numel() for p in model.parameters())
            bounds[tag] = (2 * n_rays * S * macs_per_point(model), 4 * (n_rays * 7 + n_par))
            launch_counts[tag] = n
    ms = {t: {n: min(v) for n, v in d.items()} for t, d in times.items()}
    kernels = []
    for tag, d in ms.items():
        flops, nbytes = bounds[tag]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        print(f"[timing] {card}: {tag}, bf16: kernel {d['kernel']:.4f} ms, plain "
              f"{d['plain']:.4f} ms; bound {max(t_ops, t_bytes):.4f} ms "
              f"({'operations' if t_ops >= t_bytes else 'bytes'}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB) (all runs {json.dumps(times[tag])})", flush=True)
    print(f"[timing] {card}: the full-width K2 spill launch's buffers: {json.dumps(buf)}",
          flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)
    entries = (("fused_loss_grads spill route, tensor cores (full width 8 x 256)",
                "K2 full width, spill, tensor cores", "tinynerf_tpu_torch/csrc/fused_train.cu",
                "tinynerf_tpu/kernels/fused_train.py:263", errs["F4c 8 x 256", torch.bfloat16]),
               ("fused_loss_grads spill route, CUDA cores (hidden 264, S=192)",
                "K2 hidden 264, S=192, spill, CUDA cores", "tinynerf_tpu_torch/csrc/fused_train.cu",
                "tinynerf_tpu/kernels/fused_train.py:263",
                errs["F4c hidden 264, S=192", torch.bfloat16]),
               ("fused_render_rays general kernel (hidden 264, S=192, segments of 128)",
                "K1 hidden 264, S=192, rounds and segments",
                "tinynerf_tpu_torch/csrc/fused_render.cu",
                "tinynerf_tpu/kernels/fused_render.py:211",
                errs["K1", "F4d hidden 264, S=192", torch.bfloat16]))
    for name, tag, source, replaces, err in entries:
        flops, nbytes = bounds[tag]
        kernels.append(kernel_entry(name, source, replaces, launch_counts[tag],
                                    err["max_abs" if "max_abs" in err else "max"],
                                    ms[tag]["kernel"], ms[tag]["plain"], flops, nbytes))
    return kernels


# phase 38: every NeRF width and sample count the JAX kernels take (F6, F7).
# (tag, Config overrides): each trained fused and eager, NERF_DOMAIN_ITERS
# steps of 2048 rays, bf16, tail holdout 4.
NERF_DOMAIN_RUNS = (
    ("hidden 320", dict(hidden=320)),
    ("hidden 320, n_fine 128", dict(hidden=320, n_fine=128)),
    ("hidden 384, rgb_hidden 96", dict(hidden=384, rgb_hidden=96)),
    ("hidden 512, rgb_hidden 128", dict(hidden=512, rgb_hidden=128)),
    ("rgb_hidden 320", dict(rgb_hidden=320)),
    ("n_samples 65", dict(n_samples=65)),
    ("n_samples 100", dict(n_samples=100)),
    ("hidden 256, n_samples 100, n_fine 128", dict(hidden=256, n_samples=100, n_fine=128)),
)
# Steps of each run. In their first steps fused and eager runs pass a
# transient (train PSNR down to 5.64 dB at step 10, held-out 4.24 dB) at
# steps that differ between the two: at 10 steps hidden 320's held-out
# views read 4.24 dB fused and 8.82 eager; at 60, 7.89 and 8.90.
NERF_DOMAIN_ITERS = 60
NERF_DOMAIN_SP_ITERS = 3  # the 2-rank sample-parallel runs at hidden 320 (K7), side by side


def _nerf_domain_case(hidden, rgb_hidden, dev, n_rays, seed=1):
    """A flagship-shaped NeRF MLP (L 10, L_dir 4, depth 8, skip 4) at the
    given widths, bf16, seeded; n_rays rays toward the scene, targets."""
    import numpy as np

    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP

    cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=torch.bfloat16)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed), device=dev)
    rng = np.random.RandomState(38 + seed)
    ro = torch.from_numpy((rng.randn(n_rays, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32))
    rd = rng.randn(n_rays, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[:, 2] = -np.abs(rd[:, 2])
    tgt = torch.from_numpy(rng.rand(n_rays, 3).astype(np.float32))
    return mlp, cfg, ro.to(dev), torch.from_numpy(rd).to(dev), tgt.to(dev)


def run_nerf_domain() -> list:
    """Phase 38: K3-K7 at every NeRF width and sample count the JAX kernels
    take (F6: widths past 256, blocks past 512 threads or 227 KB; F7:
    sample counts whose walk tile ends in a partial 128-point chunk, and
    unions no multiple of 8 divides): each kernel against its plain
    version at the main paths' shapes, every launch on the route nerf_shape
    configures; the trainer fused and eager at each shape; the K7 pair on
    two ranks at hidden 320; timings against the plain versions."""
    from tinynerf_tpu_torch import eval as eval_mod
    from tinynerf_tpu_torch import train as train_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.kernels import fused_nerf as k3_mod
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k56_mod
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4_mod
    from tinynerf_tpu_torch.kernels import fused_partials as k7_mod
    from tinynerf_tpu_torch.ops.volume import global_deltas

    dev = torch.device("cuda", 0)
    card = card_line()
    k3, k5 = k3_mod.fused_nerf_render_rays, k56_mod.fused_nerf_render_rays_streamed
    k4, k6 = k4_mod.fused_nerf_pass_grads, k56_mod.fused_nerf_pass_grads_streamed
    k7f, k7b = k7_mod.fused_block_partials_fwd, k7_mod.fused_block_partials_bwd
    wrappers = {"K3": k3, "K5": k5, "K4": k4, "K6": k6, "K7 fwd": k7f, "K7 bwd": k7b}
    data_path = os.path.join(OUT_DIR, "absent.npz")  # phase 3's synthetic scene

    def reset():
        for k in wrappers.values():
            k.launches = k.mma_launches = k.general_launches = k.spill_launches = 0

    def counts(name):
        k = wrappers[name]
        return (k.launches, k.mma_launches, k.general_launches, k.spill_launches)

    def want(n, cfg, shape):
        """n launches on the routes of `shape` (nerf_shape) at cfg's widths."""
        return (n, n * int(k4_mod.uses_tensor_cores(cfg)), n * int(shape.general),
                n * int(shape.spill))

    # 38. (a) each kernel against its plain version at the main paths'
    #     shapes, bf16 (the recipes' density noise, std 1), one launch each
    #     on its configured route; the render and the NeRF pass gates.
    t0 = time.time()
    errs, cases = {}, {}
    n = N_RAYS_TRAIN
    for tag, hidden, rgb_hidden, S, union, block, seed in (
            ("hidden 320", 320, 64, 64, 128, 64, 2),
            ("hidden 512/128", 512, 128, 64, 128, 64, 1),
            ("S=100, union 164", 128, 64, 100, 164, None, 1),
            ("hidden 256, union 228", 256, 64, 100, 228, 57, 1)):
        mlp, cfg, ro, rd, tgt = _nerf_domain_case(hidden, rgb_hidden, dev, n, seed)
        names = [nm for nm, _ in mlp.named_parameters()]
        g = torch.Generator(device=dev).manual_seed(38)
        noise = torch.randn(n, union, generator=g, device=dev)
        nc = noise[:, :S].contiguous()
        reset()
        loss, grads, w, z = k4(mlp, ro, rd, tgt, 3, n_samples=S, emit_sampling=True, sigma_noise=nc)
        c4 = counts("K4")
        want_loss, ref, _ = k4_mod.pass_grads_plain(mlp, ro, rd, tgt, z, nc, True, cfg, S)
        errs["K4", tag] = err = {"loss_rel": abs(float(loss) - float(want_loss)) / float(want_loss),
                                 **leaf_errors(grads, ref),
                                 "mma_scale_err": mma_scale_error(names, grads, ref)}
        check(c4 == want(1, cfg, k3_mod.nerf_shape(cfg, S, S)), f"K4 {tag}: one launch on its route")
        check(err["loss_rel"] < 1e-3 and err["min_cosine"] > 0.98 and err["mma_scale_err"] < MMA_SCALE
              and min(float(r.abs().max()) for r in ref) > 0, f"K4 {tag}: the bf16 pass gates")
        zu = _union(w[None], z[None], union - S)[0]
        reset()
        if block is not None:
            loss, grads = k6(mlp, ro, rd, tgt, zu, sigma_noise=noise, sample_block=block)
            shape = k3_mod.nerf_shape(cfg, union, block)
        else:
            loss, grads = k4(mlp, ro, rd, tgt, 3, zu, sigma_noise=noise, randomized=False)
            shape = k3_mod.nerf_shape(cfg, union, union)
        cf = counts("K6" if block is not None else "K4")
        want_loss, ref, _ = k4_mod.pass_grads_plain(mlp, ro, rd, tgt, zu, noise, True, cfg,
                                                    block or union)
        fname = "K6" if block is not None else "K4 fine"
        errs[fname, tag] = err = {"loss_rel": abs(float(loss) - float(want_loss)) / float(want_loss),
                                  **leaf_errors(grads, ref),
                                  "mma_scale_err": mma_scale_error(names, grads, ref)}
        check(cf == want(1, cfg, shape), f"{fname} {tag}: one launch on its route")
        check(err["loss_rel"] < 1e-3 and err["min_cosine"] > 0.98 and err["mma_scale_err"] < MMA_SCALE,
              f"{fname} {tag}: the bf16 pass gates")
        with torch.no_grad():
            reset()
            got3, got_w = k3(mlp, ro, rd, n_samples=S, return_weights=True)
            c3 = counts("K3")
            want3, want_w = k3_mod.fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=S,
                                                                return_weights=True)
            rb = k3_mod.default_sample_block(union, 64)
            got5 = k5(mlp, ro, rd, zu, sample_block=rb)
            c5 = counts("K5")
            want5 = k56_mod.fused_nerf_render_rays_streamed_plain(mlp, ro, rd, zu, sample_block=rb)
        errs["K3", tag] = ray_errors(got3, want3)
        errs["K3 weights", tag] = ray_errors(got_w, want_w, width=S)
        errs["K5", tag] = ray_errors(got5, want5)
        check(c3 == want(1, cfg, k3_mod.nerf_shape(cfg, S, S, walk=False))
              and c5 == want(1, cfg, k3_mod.nerf_shape(cfg, union, rb, walk=False)),
              f"K3, K5 {tag}: one launch each on its route")
        check(all(within(errs[k, tag], torch.bfloat16) for k in ("K3", "K3 weights", "K5")),
              f"K3, K5 {tag}: the bf16 render gates")
        cases[tag] = (mlp, cfg, ro, rd, tgt, nc, noise, zu, S, union, block)
        print(f"[domain] {tag}: K4 {k3_mod.nerf_shape(cfg, S, S).route} "
              f"{json.dumps(errs['K4', tag])}; {fname} {shape.route} "
              f"{json.dumps(errs[fname, tag])}; K3 {json.dumps(errs['K3', tag])}; K5 (block {rb}) "
              f"{json.dumps(errs['K5', tag])}", flush=True)
    # The K7 pair at hidden 320: one shard of the union 128 in blocks of 64.
    mlp, cfg, ro, rd, tgt, _, noise, zu, *_ = cases["hidden 320"]
    d = global_deltas(zu, rd)
    shard, sd, sn = (x[:, :64].contiguous() for x in (zu, d, noise))
    shape7 = k3_mod.launch_shape(cfg, 64, 64, walk=True, route=None)
    tile = shape7.tile_rays
    reset()
    out6, tin, _, w_fwd, w_mma = k7f(mlp, cfg, ro, rd, shard, sd, sn, 64, shape7, False)
    g_ray = torch.rand(n, 6, generator=torch.Generator(device=dev).manual_seed(39), device=dev) / n
    grads = k7b(mlp, cfg, ro, rd, shard, sd, sn, tin, g_ray, None, w_fwd, w_mma, 64, shape7)
    check(counts("K7 fwd") == counts("K7 bwd") == want(1, cfg, shape7) and n % tile == 0,
          "K7 at hidden 320: one forward and one backward launch on the general walk")
    with torch.no_grad():
        parts, _ = k7_mod.block_partials_plain(mlp, ro, rd, shard, sd, sn, sample_block=64)
    want6 = torch.stack([parts["C"][:, 0], parts["C"][:, 1], parts["C"][:, 2], parts["A"],
                         parts["T"], parts["D"] / 6.0], dim=1)
    got6 = torch.cat([out6[:, :5], out6[:, 5:] / 6.0], dim=1)
    errs["K7 fwd", "hidden 320"] = ray_errors(got6, want6, width=6)
    cot = {"C": g_ray[:, :3], "A": g_ray[:, 3], "T": g_ray[:, 4], "D": g_ray[:, 5]}
    ref = k7_mod.block_partials_grads_plain(mlp, ro, rd, shard, sd, sn, cot, sample_block=64)
    names = [nm for nm, _ in mlp.named_parameters()]
    errs["K7 bwd", "hidden 320"] = err = {**leaf_errors(grads, ref),
                                          "mma_scale_err": mma_scale_error(names, grads, ref)}
    check(within(errs["K7 fwd", "hidden 320"], torch.bfloat16) and err["min_cosine"] > 0.98,
          "K7 at hidden 320: the render gates on the partials, cosine > 0.98 on the gradients")
    print(f"[domain] K7 at hidden 320 ({shape7.route}): forward {json.dumps(errs['K7 fwd', 'hidden 320'])}"
          f"; backward {json.dumps(err)}", flush=True)
    print(f"[domain] (a) ok in {time.time() - t0:.2f}s", flush=True)

    # 38. (b) the trainer fused and eager at each shape, and eval of the
    #     fused hidden-320 checkpoint (K3): every launch on its route.
    t0 = time.time()
    trained = {}
    for tag, kw in NERF_DOMAIN_RUNS:
        runs = {}
        for fused in (True, False):
            name = "fused" if fused else "eager"
            cfg = Config(model="nerf", data_path=data_path, iters=NERF_DOMAIN_ITERS, holdout=4,
                         resume=False, log_every=10,
                         out_dir=os.path.join(OUT_DIR, f"domain_{name}"),
                         ckpt_path=os.path.join(OUT_DIR, f"domain_{name}.npz"),
                         metrics_path=os.path.join(OUT_DIR, f"domain_{name}.jsonl"),
                         fused_train=fused, fused=fused, **kw)
            if os.path.exists(cfg.metrics_path):
                os.unlink(cfg.metrics_path)
            reset()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                res = train_mod.main(cfg)
            route = [l for l in out.getvalue().splitlines() if "route" in l]
            runs[name] = {k: counts(k) for k in ("K4", "K6", "K3", "K5")}
            runs[name]["heldout"] = res["eval"]["psnr_mean"]
            psnrs = [round(p, 2) for p in logged_psnrs(cfg.metrics_path)]
            print(f"[domain] train {tag} {name}, {NERF_DOMAIN_ITERS} steps: {route}; (launches, "
                  f"tensor cores, general, spill) {json.dumps({k: runs[name][k] for k in ('K4', 'K6', 'K3', 'K5')})}"
                  f"; train PSNR every 10 steps {psnrs}; held-out {res['eval']['psnr_mean']:.2f} dB, "
                  f"{res['rays_per_sec']:,.0f} rays/s", flush=True)
        ncfg = k3_mod.padded_cfg(cfg.nerf_cfg())
        S, union = cfg.n_samples, cfg.n_samples + cfg.n_fine
        block = k4_mod.fine_pass_route(cfg.train_settings(), ncfg, cfg.n_fine)
        it = NERF_DOMAIN_ITERS
        want4 = want(it, ncfg, k3_mod.nerf_shape(ncfg, S, S))
        if block is None:
            fine4 = want(it, ncfg, k3_mod.nerf_shape(ncfg, union, union))
            want4 = tuple(a + b for a, b in zip(want4, fine4))
        want6 = want(it, ncfg, k3_mod.nerf_shape(ncfg, union, block)) if block else (0,) * 4
        f = runs["fused"]
        check(f["K4"] == want4 and f["K6"] == want6,
              f"train {tag}: K4 (and K6) every step on the routes nerf_shape configures")
        check(f["K3"][0] > 0 and all(runs["eager"][k][0] == 0 for k in ("K4", "K6", "K3", "K5")),
              f"train {tag}: K3 renders the held-out views; the eager run launches none")
        gap = abs(runs["fused"]["heldout"] - runs["eager"]["heldout"])
        print(f"[domain] train {tag}: held-out PSNR fused vs eager {gap:.3f} dB apart", flush=True)
        check(gap <= 1.5, f"train {tag}: fused and eager held-out within 1.5 dB")
        trained[tag] = runs
        if tag == "hidden 320":
            ckpt = os.path.join(OUT_DIR, "domain_fused.npz")
            reset()
            ev = eval_mod.main(eval_mod.EvalConfig(ckpt_path=ckpt, data_path=data_path, views=2,
                                                   out_dir=os.path.join(OUT_DIR, "domain_eval")))
            c = counts("K3")
            print(f"[domain] eval of the hidden-320 checkpoint: K3 (launches, tensor cores, "
                  f"general, spill) {c}, PSNR {ev['psnr_mean']:.3f} dB", flush=True)
            check(c[0] > 0 and c[2] == c[0] and math.isfinite(ev["psnr_mean"]),
                  "eval at hidden 320 serves through K3's general kernel")
    k5c = trained["hidden 320, n_fine 128"]["fused"]["K5"]
    check(k5c[0] > 0 and k5c[2] == k5c[0], "hidden 320, n_fine 128: the held-out views' fine "
          "pass through K5's general kernel")
    with ThreadPoolExecutor(max_workers=2) as pool:  # two 2-rank runs share the card
        sp = dict(zip(("fused", "eager"), pool.map(
            lambda a: torchrun_train(f"domain_sp_{a[0]}", "--hidden", "320", "--n-fine", "64",
                                     "--sample-parallel", "2", "--iters",
                                     str(NERF_DOMAIN_SP_ITERS), "--no-resume", *a[1]),
            (("fused", ()), ("eager", ("--no-fused-train", "--no-fused"))))))
    c7 = [(r.get("fused_block_partials_fwd", 0), r.get("fused_block_partials_fwd.general_launches", 0),
           r.get("fused_block_partials_bwd", 0), r.get("fused_block_partials_bwd.general_launches", 0))
          for r in sp["fused"]["launches"]]
    held = {k: float(v["out"].split("[eval] held-out PSNR over")[1].split("mean ")[1].split(" dB")[0])
            for k, v in sp.items()}
    print(f"[domain] sample-parallel 2 at hidden 320, {NERF_DOMAIN_SP_ITERS} steps: K7 (forward, "
          f"general, backward, general) per rank {c7}; held-out fused {held['fused']:.2f} dB, eager "
          f"{held['eager']:.2f} dB", flush=True)
    check(all(c[0] > 0 and c[0] == c[1] == c[2] == c[3] for c in c7),
          "sample-parallel 2 at hidden 320: the K7 pair on the general walk")
    check(abs(held["fused"] - held["eager"]) <= 1.5, "sample-parallel: fused and eager held-out "
          "within 1.5 dB")
    print(f"[domain] (b) ok in {time.time() - t0:.2f}s", flush=True)

    # 38. (c) timing: plain, kernel, kernel, plain, bf16, at the new shapes.
    t0 = time.time()
    times, bounds, launch_counts, entries = {}, {}, {}, []
    t320, t512, t100, t228 = (trained[k]["fused"] for k in (
        "hidden 320", "hidden 512, rgb_hidden 128", "n_samples 100",
        "hidden 256, n_samples 100, n_fine 128"))
    specs = []
    for tag, key, run, src, rep in (
            ("hidden 320", "K4", t320, "fused_nerf_train.cu", "fused_nerf_train.py:344"),
            ("hidden 512/128", "K4", t512, "fused_nerf_train.cu", "fused_nerf_train.py:344"),
            ("S=100, union 164", "K4", t100, "fused_nerf_train.cu", "fused_nerf_train.py:344"),
            ("hidden 320", "K6", t320, "fused_nerf_train.cu", "fused_nerf_stream.py:548"),
            ("hidden 512/128", "K6", t512, "fused_nerf_train.cu", "fused_nerf_stream.py:548"),
            ("hidden 256, union 228", "K6", t228, "fused_nerf_train.cu", "fused_nerf_stream.py:548"),
            ("hidden 320", "K3", t320, "fused_nerf.cu", "fused_nerf.py:183"),
            ("hidden 512/128", "K3", t512, "fused_nerf.cu", "fused_nerf.py:183"),
            ("hidden 512/128", "K5", t512, "fused_nerf.cu", "fused_nerf_stream.py:451"),
            ("hidden 256, union 228", "K5", t228, "fused_nerf.cu", "fused_nerf_stream.py:451")):
        specs.append((tag, key, run[key][0], src, rep))
    seed = torch.tensor([3], dtype=torch.int32, device=dev)  # as the train step passes it
    for tag, key, n_launch, src, rep in specs:
        mlp, cfg, ro, rd, tgt, nc, noise, zu, S, union, block = cases[tag]
        macs = train_macs_per_point(mlp) if key in ("K4", "K6") else macs_per_point(mlp)
        n_par = sum(p.numel() for p in mlp.parameters())
        if key == "K4":
            fns = {"kernel": lambda: k4(mlp, ro, rd, tgt, seed, n_samples=S, sigma_noise=nc),
                   "plain": lambda: k4_mod.pass_grads_plain(
                       mlp, ro, rd, tgt, k4_mod.stratified_depths(3, n, S, 2.0, 6.0, True, dev), nc,
                       True, cfg, S)}
            shape, pts = k3_mod.nerf_shape(cfg, S, S), S
        elif key == "K6":
            fns = {"kernel": lambda: k6(mlp, ro, rd, tgt, zu, sigma_noise=noise, sample_block=block),
                   "plain": lambda: k56_mod.fused_nerf_pass_grads_streamed_plain(
                       mlp, ro, rd, tgt, zu, sigma_noise=noise, sample_block=block)}
            shape, pts = k3_mod.nerf_shape(cfg, union, block), union
        elif key == "K3":
            fns = {"kernel": lambda: k3(mlp, ro, rd, n_samples=S, return_weights=True),
                   "plain": lambda: k3_mod.fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=S,
                                                                       return_weights=True)}
            shape, pts = k3_mod.nerf_shape(cfg, S, S, walk=False), S
        else:
            rb = k3_mod.default_sample_block(union, 64)
            fns = {"kernel": lambda: k5(mlp, ro, rd, zu, sample_block=rb),
                   "plain": lambda: k56_mod.fused_nerf_render_rays_streamed_plain(
                       mlp, ro, rd, zu, sample_block=rb)}
            shape, pts = k3_mod.nerf_shape(cfg, union, rb, walk=False), union
        name = f"{key} {tag} ({shape.route})"
        with torch.no_grad() if key in ("K3", "K5") else contextlib.nullcontext():
            for which in ("plain", "kernel", "kernel", "plain"):
                times.setdefault(name, {}).setdefault(which, []).append(cuda_ms(fns[which], iters=3))
        # Floats read and written once: rays (and targets), the per-sample
        # inputs (noise; given depths and deltas), the outputs, the weights
        # (and their gradients).
        per_ray = {"K4": 9 + pts, "K6": 9 + 3 * pts, "K3": 10 + pts, "K5": 10 + 2 * pts}[key]
        bounds[name] = (2 * n * pts * macs,
                        4 * (n * per_ray + (2 if key in ("K4", "K6") else 1) * n_par))
        launch_counts[name] = n_launch
        err = errs.get((key, tag)) or errs.get(("K4 fine", tag))
        entries.append((name, src, rep, err))
    # The K7 pair at hidden 320, forward + backward as one entry each.
    mlp, cfg, ro, rd, *_ = cases["hidden 320"]
    for key, fn, plain in (
            ("K7 fwd", lambda: k7f(mlp, cfg, ro, rd, shard, sd, sn, 64, shape7, False),
             lambda: k7_mod.block_partials_plain(mlp, ro, rd, shard, sd, sn, sample_block=64)),
            ("K7 bwd", lambda: k7b(mlp, cfg, ro, rd, shard, sd, sn, tin, g_ray, None, w_fwd, w_mma,
                                   64, shape7),
             lambda: k7_mod.block_partials_grads_plain(mlp, ro, rd, shard, sd, sn, cot,
                                                       sample_block=64))):
        name = f"{key} hidden 320 ({shape7.route})"
        fns = {"kernel": fn, "plain": plain}
        with torch.no_grad() if key == "K7 fwd" else contextlib.nullcontext():
            for which in ("plain", "kernel", "kernel", "plain"):
                times.setdefault(name, {}).setdefault(which, []).append(cuda_ms(fns[which], iters=3))
        macs = macs_per_point(mlp) if key == "K7 fwd" else train_macs_per_point(mlp)
        n_par = sum(p.numel() for p in mlp.parameters())
        # Rays, depths, deltas, noise; the partials and entry transmittances
        # (forward) or those and the cotangents (backward); the weights.
        per_ray = 13 + 3 * 64 + (7 if key == "K7 bwd" else 0)
        bounds[name] = (2 * n * 64 * macs,
                        4 * (n * per_ray + (2 if key == "K7 bwd" else 1) * n_par))
        launch_counts[name] = sum(c[0] for c in c7)
        entries.append((name, "fused_partials.cu", "fused_partials.py:381", errs[key, "hidden 320"]))
    kernels = []
    for name, src, rep, err in entries:
        d = {k: min(v) for k, v in times[name].items()}
        flops, nbytes = bounds[name]
        entry = kernel_entry(f"{name}, bf16", f"tinynerf_tpu_torch/csrc/{src}",
                             f"tinynerf_tpu/kernels/{rep}", launch_counts[name],
                             err["max_abs" if "max_abs" in err else "max"], d["kernel"], d["plain"],
                             flops, nbytes)
        kernels.append(entry)
        print(f"[timing] {card}: {name}, bf16: kernel {d['kernel']:.4f} ms, plain "
              f"{d['plain']:.4f} ms; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); launches in (b) "
              f"{launch_counts[name]} (all runs {json.dumps(times[name])})", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)
    return kernels



GRID_PUBLISHED = dict(n_levels=16, features=2, base_res=16, max_res=2048, table_size=1 << 19)


def run_grid_kernel() -> list:
    """Phase 39: G, the hash-grid encoding, against its plain versions."""
    from tinynerf_tpu_torch.models.grid_nerf import GridNeRFConfig
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays
    from tinynerf_tpu_torch.ops.rays import get_rays
    from tinynerf_tpu_torch.ops.sampling import stratified_samples
    from tinynerf_tpu_torch.synthetic import hemisphere_poses

    dev = torch.device("cuda", 0)
    card = card_line()
    t0 = time.time()
    lib, secs = timed_build("grid_encode")
    print(f"[build] grid_encode.cu -> {lib.name} in {secs:.2f}s; ptxas: " + "; ".join(
        line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
        if "registers" in line), flush=True)
    # 4096 rays of a 400 x 400 view (the benchmark's size) x 64 samples in [2, 6].
    gen = torch.Generator(device=dev).manual_seed(39)
    ro, rd = get_rays(400, 400, 555.5555, torch.from_numpy(hemisphere_poses()[7]).to(dev))
    pick = torch.randperm(ro.shape[0], generator=gen, device=dev)[:4096]
    ro, rd = ro[pick], rd[pick]
    pts = stratified_samples(2.0, 6.0, 64, ro, rd, generator=gen)[1].reshape(-1, 3)
    box = tuple(float(v) for v in aabb_from_rays(ro, rd, 2.0, 6.0).reshape(6).tolist())
    kernels = []
    for case, kw in (("published sizes", GRID_PUBLISHED), ("JAX defaults", {})):
        kernels += grid_kernel_case(case, GridNeRFConfig(aabb=box, **kw), pts, gen, dev, card)
    print(f"[grid kernel] ok in {time.time() - t0:.2f}s", flush=True)
    return kernels


@torch.no_grad()
def grid_kernel_case(case: str, cfg, pts, gen, dev, card) -> list:
    """Phase 39 at one configuration: G against the plain versions, timed."""
    from torch.profiler import ProfilerActivity, profile

    from tinynerf_tpu_torch.kernels import grid_encode as G
    from tinynerf_tpu_torch.models import grid_nerf
    from tinynerf_tpu_torch.models.grid_nerf import GridNeRF

    m = GridNeRF(cfg, generator=torch.Generator().manual_seed(5), device=dev)
    for t in m.tables.values():
        t.uniform_(-1.0, 1.0, generator=gen)
    lo, hi = grid_nerf._box(cfg.aabb, dev)
    u = torch.clamp((pts - lo) / (hi - lo), 0.0, 1.0)
    tables = [m.tables[f"l{l}"] for l in range(cfg.n_levels)]
    sizes = [t.shape[0] for t in tables]
    up = torch.randn(u.shape[0], cfg.n_levels * cfg.features, generator=gen, device=dev)
    before = (G.grid_encode_fwd.launches, G.grid_encode_bwd.launches)
    feats = G.grid_encode_fwd(tables, u, cfg)
    grads = [G.grid_encode_bwd(up, u, cfg, sizes) for _ in range(2)]
    launches = (G.grid_encode_fwd.launches - before[0], G.grid_encode_bwd.launches - before[1])
    want = grid_nerf.encode_levels_bwd_plain(up, u, cfg, sizes)
    same = (torch.equal(feats, grid_nerf.encode_levels_plain(tables, u, cfg)),
            all(torch.equal(a, b) for a, b in zip(grads[0], want)),
            all(torch.equal(a, b) for a, b in zip(*grads)))
    per_call = (1, G.launches(cfg.n_levels, cfg.features, True))
    print(f"[grid kernel] {case}, {u.shape[0]} points: features, every table's gradient and a "
          f"second backward bit-identical {same}; launches (a forward, two backward) {launches}",
          flush=True)
    check(all(same) and launches == (1, 2 * per_call[1]) and per_call == (1, 5),
          f"G at the {case}: bit-identical to the plain versions, repeatable, 1 + 5 launches")
    passes = {"fwd": (lambda: G.grid_encode_fwd(tables, u, cfg),
                      lambda: grid_nerf.encode_levels_plain(tables, u, cfg)),
              "bwd": (lambda: G.grid_encode_bwd(up, u, cfg, sizes),
                      lambda: grid_nerf.encode_levels_bwd_plain(up, u, cfg, sizes))}
    n, width = u.shape[0], cfg.n_levels * cfg.features
    # A pass: the blend's multiply-adds; the points, every table entry and
    # the features in f32, each once (gpubench/systems/grid.py's count).
    flops, nbytes = 2 * 8 * width * n, 4 * (3 * n + sum(sizes) * cfg.features + width * n)
    kernels = []
    for name, (kernel, plain) in passes.items():
        times = {}
        for which in ("plain", "kernel", "kernel", "plain"):
            times.setdefault(which, []).append(
                cuda_ms(kernel if which == "kernel" else plain, iters=20))
        d = {k: min(v) for k, v in times.items()}
        entry = kernel_entry(f"G {name}, {case}", "tinynerf_tpu_torch/csrc/grid_encode.cu",
                             "none (XLA by design)", per_call[name == "bwd"], 0.0, d["kernel"],
                             d["plain"], flops, nbytes)
        kernels.append(entry)
        print(f"[timing] {card}: G {name}, {case}: kernel {d['kernel']:.4f} ms, plain "
              f"{d['plain']:.4f} ms; bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}; "
              f"{nbytes / 1e6:.2f} MB) (all runs {json.dumps(times)})", flush=True)
    if case == "published sizes":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                passes["fwd"][0]()
                passes["bwd"][0]()
            torch.cuda.synchronize()
        stages = {e.key[:60]: round(e.device_time_total / 10 / 1e3, 4)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total}
        print(f"[grid kernel] device ms a call of each stage: "
              f"{json.dumps(dict(sorted(stages.items(), key=lambda kv: -kv[1])))}", flush=True)
    return kernels

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    sources = ("fused_render", "fused_train", "fused_nerf", "fused_nerf_train", "fused_partials")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:  # one nvcc per source, together
        builds = {n: pool.submit(timed_build, n) for n in sources}
        kernels = [run(builds["fused_render"]), run_train(builds["fused_train"]),
                   *run_nerf(builds["fused_nerf"]), *run_nerf_train(builds["fused_nerf_train"]),
                   *run_partials(builds["fused_partials"])]
        run_levers(builds["fused_nerf_train"], builds["fused_partials"])
        run_slice()
        run_grid()
        run_scenes()
        run_multiscene()
        kernels += run_tiny_domain(builds["fused_render"], builds["fused_train"])
        kernels += run_nerf_domain()
        kernels += run_grid_kernel()
    print(f"[phases] 1-39 in {time.time() - t_start:.2f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
