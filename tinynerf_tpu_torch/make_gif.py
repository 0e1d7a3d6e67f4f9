"""Novel-view spiral GIF renderer.

Port of tinynerf_tpu/make_gif.py:32-90: load a TinyNeRF or full-NeRF
checkpoint (rebuilding the model from its stored cfg), build a 60-frame
spiral path around pose 0 (radius 0.3), render every frame and write
<out_path> at fps=15, loop=0; --depth renders the depth spiral instead
(the geometry renderer, render.pack_aux: near bright, rays with acc
below 0.1 black). Frames are quantized to uint8 on the device before the
copy to the host.

    python -m tinynerf_tpu_torch.make_gif --ckpt-path <ckpt.npz> [--no-fused] [--depth]
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.ops.camera import spiral_poses
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.image_io import write_gif
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer


@dataclass
class GifConfig:
    ckpt_path: str = "checkpoints/tinynerf_latest.npz"
    data_path: str = "data/tiny_nerf_data.npz"
    out_path: str = "outputs/novel_views.gif"
    n_frames: int = 60
    radius: float = 0.3
    fps: int = 15
    n_samples: int = 64
    near: float = 2.0
    far: float = 6.0
    chunk: int = 8192
    fused: bool = True  # render through the fused CUDA kernel
    depth: bool = False  # the depth spiral (disparity-style tone map) instead of colour
    allow_synthetic: bool = True
    device: str = "cuda"


def main(cfg: GifConfig = GifConfig()) -> np.ndarray:
    """Render the spiral; returns the (F, H, W, 3) uint8 frames."""
    device = torch.device(cfg.device)
    d = ensure_data(cfg.data_path, allow_synthetic=cfg.allow_synthetic, device=device)
    focal = float(d["focal"])
    _, H, W, _ = d["images"].shape

    model, renderer, meta = load_model_and_renderer(
        cfg.ckpt_path, H=H, W=W, focal=focal, n_samples=cfg.n_samples,
        near=cfg.near, far=cfg.far, chunk=cfg.chunk, fused=cfg.fused,
        frames=True, aux=cfg.depth, device=device,
    )
    print(f"[ckpt] loaded {cfg.ckpt_path} (step {meta['step']}, model {meta['model']})")

    path = spiral_poses(torch.from_numpy(d["poses"][0]).to(device), n_frames=cfg.n_frames,
                        radius=cfg.radius)
    t0 = time.time()
    out = renderer(model, path)
    if cfg.depth:
        # shade = disparity gated on acc >= 0.1, broadcast to grey rgb.
        shade = (1.0 - out[..., 0]) * (out[..., 1] >= 0.1)
        out = shade[..., None].expand(*shade.shape, 3)
    frames = (torch.clamp(out, 0.0, 1.0) * 255).to(torch.uint8)
    frames = frames.cpu().numpy()  # waits for the device
    dt = time.time() - t0
    write_gif(cfg.out_path, list(frames), fps=cfg.fps, loop=0)
    print(f"[ok] wrote {cfg.out_path} ({cfg.n_frames} frames in {dt:.1f}s)")
    return frames


if __name__ == "__main__":
    main(cli(GifConfig, description="Render a novel-view spiral GIF (PyTorch + CUDA)"))
