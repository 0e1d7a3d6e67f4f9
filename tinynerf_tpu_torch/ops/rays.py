"""Pinhole-camera ray generation.

Port of tinynerf_tpu/ops/rays.py:19-99: pixel grid in "xy" indexing,
camera looks along -z, directions rotated by c2w[:3,:3] and
unit-normalized, origins broadcast from c2w[:3,3]; ndc_rays reprojects
rays of a forward-facing capture to NDC space.
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


def ndc_rays(H: int, W: int, focal, near, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Rays of a forward-facing capture in NDC space (the NeRF paper's
    appendix C; tinynerf_tpu/ops/rays.py:58-84): origins shifted to the
    z = -near plane, then the projective map that sends the viewing
    frustum to the [-1, 1]^3 cube, so uniform t in [0, 1] is uniform
    disparity in world space. Needs dz < 0 on every ray. The directions
    come out unnormalised: their norm scales the deltas, as in the JAX
    package. Works on any leading shape (..., 3); float32, elementwise in
    the JAX package's order."""
    rays_o = torch.as_tensor(rays_o, dtype=torch.float32)
    rays_d = torch.as_tensor(rays_d, dtype=torch.float32)
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o0 = -focal / (0.5 * W) * ox / oz
    o1 = -focal / (0.5 * H) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -focal / (0.5 * W) * (dx / dz - ox / oz)
    d1 = -focal / (0.5 * H) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def get_rays_for_poses(H: int, W: int, focal, c2ws: torch.Tensor):
    """(N, H*W, 3) origins and directions for a stack of (N, 4, 4) poses."""
    rays = [get_rays(H, W, focal, c2w) for c2w in torch.as_tensor(c2ws)]
    return torch.stack([r[0] for r in rays]), torch.stack([r[1] for r in rays])
