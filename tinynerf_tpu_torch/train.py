"""Training driver: `python -m tinynerf_tpu_torch.train --iters 20000 ...`

Port of the TinyNeRF and full-NeRF (coarse proposal) branches of
tinynerf_tpu/train.py:36-738: seed and data, model and Adam, resume of
params, optimizer and step from the checkpoint, rays precomputed for
every pose, an optional tail holdout, steps in blocks cut at every
log/preview/checkpoint boundary, a log line and a JSONL record every
log_every, preview PNGs, checkpoints, the final checkpoint and
final.png, the final evaluation and the "[done] ... rays/s" line. The
checkpoint's meta is the JAX driver's (the TinyNeRF subset for
--model tinynerf), so the JAX eval and make_gif read it and the JAX
trainer resumes it.

Gradients go through the fused CUDA train kernels unless
--no-fused-train, which runs the loss (training.loss_fn, or
models/nerf.make_hierarchical_loss for --model nerf) with autograd:
TinyNeRF through K2 (kernels/fused_train.py), the full NeRF through K4
for the coarse pass and K4 or the streamed K6 for the fine pass
(kernels/fused_nerf_train.py). The NeRF's previews and evaluation render
through the hierarchical renderer (K3/K5 with --fused). Metrics stay on
the device inside a block; the host reads them only at a log point.

    python -m tinynerf_tpu_torch.train [--model nerf] [--iters N] [--no-fused-train]
"""

from __future__ import annotations

import json
import os
import time

import torch

from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.evaluation import evaluate_views
from tinynerf_tpu_torch.main import _sync
from tinynerf_tpu_torch.ops.rays import get_rays_for_poses
from tinynerf_tpu_torch.models.nerf import NeRF, make_hierarchical_loss
from tinynerf_tpu_torch.render import make_hierarchical_image_renderer, make_image_renderer
from tinynerf_tpu_torch.training import init_train_state, make_train_block
from tinynerf_tpu_torch.utils import checkpoint as ckpt_lib
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png


def _boundaries(start: int, end: int, *cadences: int):
    """Yield (block_start, block_len) segments cut at every cadence multiple."""
    step = start
    while step < end:
        nxt = min([end] + [((step // c) + 1) * c for c in cadences if c > 0])
        yield step, nxt - step
        step = nxt


def main(cfg: Config = Config()) -> dict:
    if cfg.model not in ("tinynerf", "nerf"):
        raise NotImplementedError(
            f"training --model {cfg.model} is not ported yet (ROADMAP.md, queue 1, item 12)"
        )
    if cfg.proposal not in ("coarse", "occupancy"):
        raise ValueError(f"unknown proposal {cfg.proposal!r} (coarse|occupancy)")
    if cfg.proposal == "occupancy":
        if cfg.model != "nerf":
            raise ValueError("--proposal occupancy requires --model nerf")
        raise NotImplementedError(
            "the occupancy proposal is not ported yet (ROADMAP.md, queue 1, item 11)"
        )
    nerf = cfg.model == "nerf"
    t_start = time.time()
    device = torch.device(cfg.device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[device] {device} ({name}) torch={torch.__version__}")

    d = ensure_data(cfg.data_path, allow_synthetic=cfg.allow_synthetic, device=device)
    images = torch.from_numpy(d["images"]).to(device)
    poses = torch.from_numpy(d["poses"]).to(device)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape
    print(
        f"[data] N={n_images} H={H} W={W} focal={focal:.2f}"
        + (" (synthetic)" if d.get("synthetic") else "")
    )

    settings = cfg.train_settings()
    print(f"[train] sigma_noise(std={settings.sigma_noise_std})")
    loss = init_fn = None
    if nerf:
        ncfg = cfg.nerf_cfg()
        loss = make_hierarchical_loss(ncfg, n_fine=cfg.n_fine)

        def init_fn(generator, dev):
            return NeRF(ncfg, generator=generator, device=dev)

    model, optimizer = init_train_state(
        torch.Generator().manual_seed(cfg.seed), settings, device=device, init_fn=init_fn
    )

    start_step = 0
    if cfg.resume and ckpt_lib.latest_exists(cfg.ckpt_path):
        start_step, _ = ckpt_lib.restore_checkpoint(cfg.ckpt_path, model, optimizer)
        print(f"[resume] loaded {cfg.ckpt_path} from step {start_step}")

    rays_o_all, rays_d_all = get_rays_for_poses(H, W, focal, poses)
    pixels = images.reshape(n_images, H * W, 3)

    n_train = n_images - cfg.holdout
    holdout_indices = list(range(n_train, n_images))
    if cfg.holdout > 0:
        if n_train < 1:
            raise ValueError(f"--holdout {cfg.holdout} leaves no training pose of {n_images}")
        rays_o_all, rays_d_all = rays_o_all[:n_train], rays_d_all[:n_train]
        pixels = pixels[:n_train]
        print(f"[eval] holding out poses {n_train}..{n_images - 1}")

    grad_fn = None
    if cfg.fused_train:
        on_card = device.type == "cuda"
        route = "CUDA kernel" if on_card else "its plain version on the CPU"
        if nerf:
            from tinynerf_tpu_torch.kernels.fused_nerf_train import (
                fine_pass_route,
                make_fused_nerf_grad_fn,
            )

            grad_fn = make_fused_nerf_grad_fn(settings, ncfg, n_fine=cfg.n_fine)
            block = fine_pass_route(settings, ncfg, cfg.n_fine)
            fine = "K4" if block is None else f"streamed K6, sample block {block}"
            route = (f"{'CUDA kernels' if on_card else 'their plain versions on the CPU'}: "
                     f"coarse pass K4, fine pass {fine}")
        else:
            from tinynerf_tpu_torch.kernels.fused_train import make_fused_grad_fn

            grad_fn = make_fused_grad_fn(settings)
        print(f"[train] fused fwd+bwd train route: {route}")

    if nerf:
        renderer = make_hierarchical_image_renderer(
            H=H, W=W, focal=focal, chunk=min(cfg.chunk, 4096), n_coarse=cfg.n_samples,
            n_fine=cfg.n_fine, near=cfg.near, far=cfg.far, nerf_cfg=ncfg, use_fused=cfg.fused,
        )
        mcfg = {
            "hidden": cfg.hidden, "depth": cfg.nerf_depth, "skip_at": cfg.nerf_skip_at,
            "num_freqs": cfg.num_freqs, "num_freqs_dir": cfg.num_freqs_dir,
            "rgb_hidden": cfg.rgb_hidden, "n_fine": cfg.n_fine, "ndc": False,
            "proposal": cfg.proposal,
        }
    else:
        renderer = make_image_renderer(
            H=H, W=W, focal=focal, chunk=cfg.chunk, n_samples=cfg.n_samples,
            near=cfg.near, far=cfg.far, num_freqs=cfg.num_freqs,
            model_cfg=cfg.model_cfg(), use_fused=cfg.fused,
        )
        mcfg = {"hidden": cfg.hidden, "depth": cfg.depth, "skip_at": cfg.skip_at,
                "num_freqs": cfg.num_freqs, "ndc": False}

    meta = {
        "in_dim": cfg.model_cfg().in_dim,
        "model": cfg.model,
        **(
            {"holdout": {"count": cfg.holdout, "mode": "tail", "indices": holdout_indices}}
            if cfg.holdout > 0 else {}
        ),
        "cfg": mcfg,
    }

    def save_ckpt(step: int):
        ckpt_lib.save_checkpoint(cfg.ckpt_path, model, optimizer, step, meta=meta)

    blocks = {}  # block_size -> block function
    last = {}
    metrics_f = open(cfg.metrics_path, "a") if cfg.metrics_path else None
    try:
        _sync(device)
        t0 = time.time()
        for block_start, block_len in _boundaries(
            start_step, cfg.iters, cfg.log_every, cfg.preview_every, cfg.ckpt_every
        ):
            if block_len not in blocks:
                blocks[block_len] = make_train_block(settings, block_len, loss=loss,
                                                     grad_fn=grad_fn)
            metrics = blocks[block_len](
                model, optimizer, cfg.seed, block_start, rays_o_all, rays_d_all, pixels
            )
            step_end = block_start + block_len

            if step_end % cfg.log_every == 0 or step_end == cfg.iters:
                last = {"loss": float(metrics["loss"][-1]), "psnr": float(metrics["psnr"][-1])}
                print(f"[train] step {step_end}/{cfg.iters} loss {last['loss']:.6f} "
                      f"psnr {last['psnr']:.2f}", flush=True)
                if metrics_f:
                    metrics_f.write(json.dumps({"step": step_end, **last}) + "\n")
                    metrics_f.flush()

            if step_end % cfg.preview_every == 0:
                # The reference's (step % N)+1 preview pose over the poses
                # actually trained on; an explicit --preview-pose may name
                # any pose, held-out ones included.
                if cfg.preview_pose is None:
                    pose_idx = ((step_end - 1) % n_train + 1) % n_train
                else:
                    pose_idx = cfg.preview_pose % n_images
                img = renderer(model, poses[pose_idx])
                write_png(f"{cfg.out_dir}/preview_{step_end:06d}.png", img.cpu().numpy())

            if step_end % cfg.ckpt_every == 0:
                save_ckpt(step_end)
        _sync(device)
        dt = time.time() - t0
    finally:
        if metrics_f:
            metrics_f.close()

    save_ckpt(cfg.iters)
    img = renderer(model, poses[-1])
    write_png(f"{cfg.out_dir}/final.png", img.cpu().numpy())

    # Novel-view PSNR: held-out poses when available, else a spread of
    # training views.
    if cfg.holdout > 0:
        eval_idx, eval_kind = holdout_indices, "held-out"
    else:
        eval_idx = list(range(0, n_images, max(1, n_images // 8)))[:8]
        eval_kind = "train-view"
    eval_res = evaluate_views(renderer, model, images, poses, eval_idx)
    print(
        f"[eval] {eval_kind} PSNR over {len(eval_idx)} views: "
        f"mean {eval_res['psnr_mean']:.2f} dB "
        f"(min {eval_res['psnr_min']:.2f}, max {eval_res['psnr_max']:.2f})"
    )
    if cfg.metrics_path:
        with open(cfg.metrics_path, "a") as f:
            f.write(json.dumps({"step": cfg.iters, "eval": eval_res, "kind": eval_kind,
                                "final": True}) + "\n")

    trained_steps = cfg.iters - start_step
    rays_per_sec = (trained_steps * cfg.n_rand / dt) if dt > 0 and trained_steps > 0 else 0.0
    print(
        f"[done] {cfg.iters} iters in {(time.time() - t_start) / 60:.2f} min "
        f"(train loop {dt:.1f}s, {rays_per_sec:,.0f} rays/s) | "
        f"saved {cfg.ckpt_path} and {cfg.out_dir}/final.png"
    )
    return {
        "final_psnr": last.get("psnr"),
        "eval": eval_res,
        "rays_per_sec": rays_per_sec,
        "model": model,
    }


if __name__ == "__main__":
    main(cli(Config, description="Train TinyNeRF or the full NeRF (PyTorch + CUDA)"))
