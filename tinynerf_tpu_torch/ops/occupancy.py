"""The scene box of the occupancy module (tinynerf_tpu/ops/occupancy.py:47-80):
the default box and the box that bounds every sample point of a capture's
rays. The sparsity prior (ops/regularizers.py) draws its points in it.
The occupancy grid and its sampler are ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

import torch

# Half-extent of the default box: the inward-facing capture (cameras at
# radius ~4, near 2, far 6) has its content inside |x| < 2.
DEFAULT_HALF_EXTENT = 3.0


def default_aabb(half_extent: float = DEFAULT_HALF_EXTENT, device=None) -> torch.Tensor:
    """(2, 3) float32 box [-h, h]^3."""
    return torch.tensor([[-half_extent] * 3, [half_extent] * 3], dtype=torch.float32,
                        device=device)


def aabb_from_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float, far: float,
                   margin: float = 0.05) -> torch.Tensor:
    """(2, 3) box covering every sample point any ray can produce: the
    [near, far] segment endpoints of every ray, widened by `margin` of the
    extent on each side. Deterministic given the data."""
    o = rays_o.reshape(-1, 3).float()
    d = rays_d.reshape(-1, 3).float()
    pts = torch.cat([o + d * near, o + d * far], dim=0)
    lo, hi = pts.min(dim=0).values, pts.max(dim=0).values
    pad = margin * (hi - lo)
    return torch.stack([lo - pad, hi + pad], dim=0)
