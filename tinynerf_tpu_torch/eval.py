"""Evaluation driver: `python -m tinynerf_tpu_torch.eval --ckpt-path ...`

Port of tinynerf_tpu/eval.py:27-162: render a set of dataset views from
a checkpoint, report per-view and aggregate PSNR and SSIM into
<out_dir>/metrics.json, and optionally save the renders, per-view error
maps and (--save-depth) depth and opacity maps, depth_<i>.png and
acc_<i>.png, from a twin geometry renderer (render.pack_aux) over the
same checkpoint; an NDC checkpoint's depths are unpacked over [0, 1].
--holdout-views scores exactly the poses the checkpoint recorded as held
out; --ema scores the `<ckpt>.ema.npz` Polyak twin where one exists;
--n-fine overrides a full NeRF's fine-sample budget.

    python -m tinynerf_tpu_torch.eval --ckpt-path <ckpt.npz> [--views 8] [--n-fine N] [--no-fused] [--save-depth]
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.evaluation import evaluate_views
from tinynerf_tpu_torch.render import unpack_aux
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer


@dataclass
class EvalConfig:
    ckpt_path: str = "checkpoints/tinynerf_latest.npz"
    data_path: str = "data/tiny_nerf_data.npz"
    out_dir: str = "outputs/eval"
    views: int = 8  # number of evenly spaced views (0 = all)
    first_view: int = 0  # start index over the original pose order
    holdout_views: bool = False  # the poses the checkpoint recorded as held out
    ema: bool = False  # score the `<ckpt-path>.ema.npz` Polyak twin
    n_samples: int = 64
    # None = the checkpoint's fine-sample count (full NeRF); an int,
    # 0 included, overrides it.
    n_fine: Optional[int] = None
    near: float = 2.0
    far: float = 6.0
    chunk: int = 8192
    fused: bool = True  # render through the fused CUDA kernel
    save_images: bool = True
    save_error_maps: bool = False  # err_<i>.png: |render - gt| averaged over rgb, 0.25 saturates
    save_depth: bool = False  # depth_<i>.png (near = bright, acc < 0.1 black) and acc_<i>.png
    allow_synthetic: bool = True
    device: str = "cuda"


def main(cfg: EvalConfig = EvalConfig()) -> dict:
    device = torch.device(cfg.device)
    d = ensure_data(cfg.data_path, allow_synthetic=cfg.allow_synthetic, device=device)
    images, poses = d["images"], torch.from_numpy(d["poses"]).to(device)
    focal = float(d["focal"])
    n_images, H, W, _ = images.shape

    ckpt_path = cfg.ckpt_path
    if cfg.ema:
        ckpt_path = cfg.ckpt_path + ".ema.npz"
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(
                f"--ema: no Polyak twin at {ckpt_path} (written only by a trainer "
                "run with --ema-decay > 0)"
            )
    model, renderer, meta = load_model_and_renderer(
        ckpt_path, H=H, W=W, focal=focal, n_samples=cfg.n_samples, near=cfg.near,
        far=cfg.far, chunk=cfg.chunk, fused=cfg.fused, n_fine=cfg.n_fine, device=device,
    )
    print(
        f"[ckpt] {ckpt_path} (model {meta['model']}, step {meta['step']}"
        + (", EMA weights" if cfg.ema else "") + ")"
    )

    if cfg.holdout_views:
        hold = meta.get("holdout")
        if not hold:
            raise ValueError(
                "--holdout-views: this checkpoint has no holdout metadata "
                "(trained without --holdout)"
            )
        indices = [int(i) for i in hold["indices"]]
        print(f"[eval] checkpoint held-out poses ({hold['mode']}): {indices}")
    else:
        pool = list(range(cfg.first_view, n_images))
        if cfg.views and cfg.views < len(pool):
            stride = max(1, len(pool) // cfg.views)
            indices = pool[::stride][: cfg.views]
        else:
            indices = pool
    res = evaluate_views(renderer, model, images, poses, indices)
    print(
        f"[eval] {len(indices)} views: PSNR mean {res['psnr_mean']:.2f} dB "
        f"(min {res['psnr_min']:.2f} / max {res['psnr_max']:.2f}), "
        f"SSIM mean {res['ssim_mean']:.4f}"
    )
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(f"{cfg.out_dir}/metrics.json", "w") as f:
        json.dump({"indices": indices, **res}, f, indent=2)
    aux_renderer = None
    if cfg.save_depth:
        # A twin geometry renderer over the same checkpoint (packed depth and
        # acc pseudo-images, render.pack_aux).
        _, aux_renderer, _ = load_model_and_renderer(
            ckpt_path, H=H, W=W, focal=focal, n_samples=cfg.n_samples, near=cfg.near,
            far=cfg.far, chunk=cfg.chunk, fused=cfg.fused, n_fine=cfg.n_fine, aux=True,
            device=device,
        )
    if cfg.save_images or cfg.save_error_maps or cfg.save_depth:
        # NDC checkpoints sample t in [0, 1] (model_io remaps near/far).
        near, far = (0.0, 1.0) if meta.get("cfg", {}).get("ndc") else (cfg.near, cfg.far)
        for i in indices:
            img = renderer(model, poses[i]).cpu().numpy()
            if cfg.save_images:
                write_png(f"{cfg.out_dir}/view_{i:03d}.png", img)
            if cfg.save_error_maps:
                err = np.clip(np.abs(img - images[i]).mean(axis=-1) / 0.25, 0.0, 1.0)
                write_png(f"{cfg.out_dir}/err_{i:03d}.png", np.stack([err, err, err], axis=-1))
            if cfg.save_depth:
                depth, acc = unpack_aux(aux_renderer(model, poses[i]).cpu().numpy(), near, far)
                # Disparity-style tone map (near = bright); empty rays (acc
                # below 0.1) black instead of the arbitrary depth a near-zero
                # weight sum would imply.
                d_norm = np.clip((depth - near) / (far - near), 0.0, 1.0)
                shade = (1.0 - d_norm) * (acc >= 0.1)
                write_png(f"{cfg.out_dir}/depth_{i:03d}.png", np.stack([shade] * 3, axis=-1))
                write_png(f"{cfg.out_dir}/acc_{i:03d}.png",
                          np.stack([np.clip(acc, 0.0, 1.0)] * 3, axis=-1))
        print(f"[eval] wrote renders + metrics.json to {cfg.out_dir}")
    return res


if __name__ == "__main__":
    main(cli(EvalConfig, description="Evaluate a checkpoint: PSNR/SSIM over views (PyTorch + CUDA)"))
