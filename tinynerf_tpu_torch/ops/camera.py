"""Camera paths for novel-view rendering.

Port of tinynerf_tpu/ops/camera.py:17-28: a circle of radius r in the
reference camera's local xy-plane, n_frames values of t over [0, 2*pi]
inclusive (the first and last frames nearly coincide),
pose = c2w_ref @ T(t).
"""

from __future__ import annotations

import math

import torch


def spiral_poses(c2w_ref: torch.Tensor, n_frames: int = 60, radius: float = 0.3) -> torch.Tensor:
    """(n_frames, 4, 4) camera poses circling the reference camera."""
    c2w_ref = torch.as_tensor(c2w_ref, dtype=torch.float32)
    t = torch.linspace(0.0, 2.0 * math.pi, n_frames, dtype=torch.float32, device=c2w_ref.device)
    T = torch.eye(4, dtype=torch.float32, device=c2w_ref.device).repeat(n_frames, 1, 1)
    T[:, 0, 3] = radius * torch.cos(t)
    T[:, 1, 3] = radius * torch.sin(t)
    # c2w_ref @ T as explicit f32 products and sums (never TF32).
    return (c2w_ref[None, :, :, None] * T[:, None, :, :]).sum(dim=2)
