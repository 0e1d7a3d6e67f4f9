"""Smoke test: render one pose with an untrained model.

Port of tinynerf_tpu/main.py:27-68: print the device and the data
shapes, render pose 0 (chunk 8192, 64 samples, near 2, far 6), write
<out_dir>/preview.png and report the render wall-clock, first call and
steady state.

    python -m tinynerf_tpu_torch.main [--device cuda] [--no-fused]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF
from tinynerf_tpu_torch.render import make_image_renderer
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_png


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(cfg: Config = Config()) -> np.ndarray:
    """Render pose 0; returns the (H, W, 3) image in [0, 1]."""
    device = torch.device(cfg.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[device] {device} ({name}) torch={torch.__version__}")
    d = ensure_data(cfg.data_path, allow_synthetic=cfg.allow_synthetic, device=device)
    n_images, H, W, _ = d["images"].shape
    focal = float(d["focal"])
    print(
        f"[data] N={n_images} H={H} W={W} focal={focal:.2f}"
        + (" (synthetic)" if d.get("synthetic") else "")
    )

    model = TinyNeRF(
        cfg.model_cfg(), generator=torch.Generator().manual_seed(cfg.seed), device=device
    )
    renderer = make_image_renderer(
        H=H, W=W, focal=focal, chunk=cfg.chunk, n_samples=cfg.n_samples,
        near=cfg.near, far=cfg.far, num_freqs=cfg.num_freqs,
        model_cfg=cfg.model_cfg(), use_fused=cfg.fused,
    )
    pose = torch.from_numpy(d["poses"][0]).to(device)

    os.makedirs(cfg.out_dir, exist_ok=True)
    t0 = time.time()
    renderer(model, pose)  # first call: builds the kernel if needed
    _sync(device)
    t_first = time.time() - t0
    t0 = time.time()
    img = renderer(model, pose)
    _sync(device)
    dt = time.time() - t0
    img = img.cpu().numpy()
    out_path = f"{cfg.out_dir}/preview.png"
    write_png(out_path, img)
    print(
        f"[render] wrote {out_path} in {dt:.3f}s steady-state "
        f"({t_first:.2f}s first call; untrained model; expect a hazy image)"
    )
    return img


if __name__ == "__main__":
    main(cli(Config, description="TinyNeRF smoke test (PyTorch + CUDA)"))
