"""Pinhole-camera ray generation.

Port of tinynerf_tpu/ops/rays.py:19-55, 87-99: pixel grid in "xy"
indexing, camera looks along -z, directions rotated by c2w[:3,:3] and
unit-normalized, origins broadcast from c2w[:3,3].
"""

from __future__ import annotations

import torch


def get_rays(H: int, W: int, focal, c2w: torch.Tensor):
    """Ray origins and unit directions for one camera pose.

    Args:
      H, W: image size.
      focal: focal length in pixels.
      c2w: (4, 4) or (3, 4) camera-to-world matrix; its device is the
        device of the rays.

    Returns:
      rays_o, rays_d: each (H*W, 3) float32.

    Pixel (w, h) maps to camera-frame direction
    [(w - W/2)/focal, -(h - H/2)/focal, -1].
    """
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs = torch.stack(
        [(i - W * 0.5) / focal, -(j - H * 0.5) / focal, -torch.ones_like(i)], dim=-1
    ).reshape(-1, 3)

    R = c2w[:3, :3]
    # Products and sums in f32 on every device: a TF32 matmul would
    # truncate directions that feed sin(2^(L-1) x).
    rays_d = (dirs[:, None, :] * R[None, :, :]).sum(dim=-1)
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_for_poses(H: int, W: int, focal, c2ws: torch.Tensor):
    """(N, H*W, 3) origins and directions for a stack of (N, 4, 4) poses."""
    rays = [get_rays(H, W, focal, c2w) for c2w in torch.as_tensor(c2ws)]
    return torch.stack([r[0] for r in rays]), torch.stack([r[1] for r in rays])
