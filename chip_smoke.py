"""Drive the PyTorch + CUDA port once on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed with its result and time:
  1. build    - compile every kernel of the render path from csrc/ (nvcc).
  2. kernel   - each kernel against its plain torch version on the card,
                at the main path's shapes (8192 rays from get_rays on a
                synthetic pose, 64 samples, hidden 128), f32 and bf16.
  3. main     - `tinynerf_tpu_torch.main` in process: untrained model,
                synthetic scene fallback at 100x100, chunk 8192. The image
                must be finite, in [0, 1], agree with the eager render of
                the same model, and the kernel's launch count must rise.
  4. make_gif - write a params-only checkpoint, render a 60-frame spiral
                from it with `tinynerf_tpu_torch.make_gif`; count again.
  5. timing   - steady-state time of one 100x100 image and of one
                8192-ray batch through each kernel and its plain version.

Exits non-zero without printing a result when there is no CUDA device,
when the package is missing, or when any phase fails. The line before
the last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Artifacts go to outputs/chip_smoke/.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

OUT_DIR = os.path.join("outputs", "chip_smoke")
N_RAYS = 8192
N_SAMPLES = 64
# Per-ray max-channel error gates. bf16: the JAX package's own render
# parity gates (bench.py:707-718); the tail gate counts rays whose last
# sample's density sits at the ReLU boundary, where the 1e10 terminal
# delta flips alpha between 0 and 1.
GATES = {
    torch.float32: {"p999": 5e-4, "mean": None, "flip": 2.5e-3},
    torch.bfloat16: {"p999": 3e-2, "mean": 1e-3, "flip": 2.5e-3},
}
FLIP_ERR = 3e-2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def ray_errors(a: torch.Tensor, b: torch.Tensor) -> dict:
    e = (a.float() - b.float()).abs().reshape(-1, 3).max(dim=1).values
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


def run() -> dict:
    from tinynerf_tpu_torch import main as main_mod
    from tinynerf_tpu_torch import make_gif as gif_mod
    from tinynerf_tpu_torch.config import Config
    from tinynerf_tpu_torch.data import ensure_data
    from tinynerf_tpu_torch.kernels import _build
    from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays, fused_render_rays_plain
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: exactly as nvidia-smi prints them

    # 1. build
    t0 = time.time()
    lib = _build.build("fused_render")
    print(f"[build] fused_render.cu -> {lib.name} in {time.time() - t0:.2f}s", flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    # 2. kernel against its plain version, at the main path's shapes
    t0 = time.time()
    pose = torch.from_numpy(hemisphere_poses()[0]).to(dev)
    rays_o, rays_d = get_rays(H, W, FOCAL, pose)
    rays_o, rays_d = rays_o[:N_RAYS].contiguous(), rays_d[:N_RAYS].contiguous()
    kw = dict(n_samples=N_SAMPLES, near=2.0, far=6.0, num_freqs=10)
    errs = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            cfg = Config(bf16=dtype == torch.bfloat16).model_cfg()
            model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(0), device=dev)
            got = fused_render_rays(model, rays_o, rays_d, **kw)
            torch.cuda.synchronize()
            want = fused_render_rays_plain(model, rays_o, rays_d, **kw)
            check(got.shape == (N_RAYS, 3) and bool(torch.isfinite(got).all()), "kernel output finite")
            errs[dtype] = err = ray_errors(got, want)
            print(f"[kernel] fused_render {str(dtype)[6:]}: {json.dumps(err)}", flush=True)
            check(within(err, dtype), f"fused_render {dtype} within {GATES[dtype]}")
    print(f"[kernel] ok in {time.time() - t0:.2f}s", flush=True)

    # 3. the main path: python -m tinynerf_tpu_torch.main, in process
    t0 = time.time()
    cfg = Config(data_path=os.path.join(OUT_DIR, "absent.npz"), out_dir=OUT_DIR, chunk=8192)
    fused_render_rays.launches = 0
    img = main_mod.main(cfg)
    launches = fused_render_rays.launches
    d = ensure_data(cfg.data_path, device=dev)  # the scene main rendered
    poses = torch.from_numpy(d["poses"]).to(dev)
    focal = float(d["focal"])
    hw = d["images"].shape[1:3]
    check(d["synthetic"] and img.shape == (*hw, 3), f"main image shape {img.shape}")
    check(bool((img >= 0).all() and (img <= 1).all()), "main image finite, in [0, 1]")
    check(launches > 0, "main launched fused_render")
    model = TinyNeRF(cfg.model_cfg(), generator=torch.Generator().manual_seed(cfg.seed), device=dev)
    eager = make_image_renderer(H=hw[0], W=hw[1], focal=focal, chunk=8192, model_cfg=cfg.model_cfg())
    err = ray_errors(torch.from_numpy(img), eager(model, poses[0]).cpu())
    print(f"[main] {hw[0]}x{hw[1]} image, launches={launches}, vs eager render: {json.dumps(err)}", flush=True)
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
    fused_render_rays.launches = 0
    frames = gif_mod.main(gif_cfg)
    gif_launches = fused_render_rays.launches
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

    # 5. timing: plain, kernel, kernel, plain
    t0 = time.time()
    with torch.no_grad():
        batch = {
            "kernel": lambda: fused_render_rays(model, rays_o, rays_d, **kw),
            "plain": lambda: fused_render_rays_plain(model, rays_o, rays_d, **kw),
        }
        image = {
            name: (lambda f=f: chunked_over_rays(lambda ro, rd: f(model, ro, rd, **kw),
                                                 *hw, focal, poses[0], 8192))
            for name, f in (("kernel", fused_render_rays), ("plain", fused_render_rays_plain))
        }
        times = {}
        for what, fns in (("batch", batch), ("image", image)):
            for name in ("plain", "kernel", "kernel", "plain"):
                times.setdefault((what, name), []).append(cuda_ms(fns[name]))
    ms = {k: min(v) for k, v in times.items()}
    print(f"[timing] {card}: {N_RAYS}-ray batch kernel {ms['batch', 'kernel']:.4f} ms, "
          f"plain {ms['batch', 'plain']:.4f} ms; {hw[0]}x{hw[1]} image kernel "
          f"{ms['image', 'kernel']:.4f} ms, plain {ms['image', 'plain']:.4f} ms "
          f"(all runs {json.dumps({' '.join(k): v for k, v in times.items()})})", flush=True)
    print(f"[timing] ok in {time.time() - t0:.2f}s", flush=True)

    return {
        "name": "fused_render_rays",
        "route": "cuda",
        "source": "tinynerf_tpu_torch/csrc/fused_render.cu",
        "replaces": "tinynerf_tpu/kernels/fused_render.py:211",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16]["max"],
        "ms": ms["batch", "kernel"],
        "plain_ms": ms["batch", "plain"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    kernels = [run()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
