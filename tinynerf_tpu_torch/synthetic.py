"""Procedural synthetic NeRF dataset (offline stand-in for tiny_nerf_data.npz).

Port of the default sphere scene of tinynerf_tpu/synthetic.py:30-90,
193-217, 250-337: colored soft-edged spheres with an analytic
emission/absorption field, ground truth rendered with the same
volume-rendering equation (dense 256-sample quadrature). Camera
geometry mimics the real dataset: 106 poses on the upper hemisphere at
radius ~4.03 looking at the origin, 100x100 images, focal ~138.9 px.
Poses are made with numpy, exactly as in the JAX package; the images
are rendered with torch on the requested device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tinynerf_tpu_torch.ops.rays import get_rays
from tinynerf_tpu_torch.ops.volume import volume_render

H = W = 100
N_POSES = 106
FOCAL = 138.88887889922103
RADIUS = 4.0311289
NEAR, FAR = 2.0, 6.0
GT_SAMPLES = 256

# (center xyz, radius, density, rgb color): an asymmetric cluster so
# novel views carry real parallax information.
_SPHERES = np.array(
    [
        # cx,    cy,    cz,    r,    dens,  R,    G,    B
        [0.00, 0.00, -0.20, 0.55, 28.0, 0.85, 0.15, 0.10],
        [0.45, 0.30, 0.25, 0.30, 35.0, 0.10, 0.55, 0.90],
        [-0.50, 0.25, 0.10, 0.28, 35.0, 0.95, 0.80, 0.10],
        [0.10, -0.50, 0.30, 0.25, 40.0, 0.15, 0.80, 0.25],
        [-0.25, -0.30, -0.45, 0.32, 30.0, 0.60, 0.20, 0.80],
        [0.35, -0.10, -0.50, 0.22, 45.0, 0.95, 0.45, 0.05],
        [0.00, 0.55, -0.30, 0.20, 45.0, 0.20, 0.90, 0.85],
        [-0.10, 0.05, 0.55, 0.24, 38.0, 0.90, 0.90, 0.90],
    ],
    dtype=np.float32,
)


def field(pts: torch.Tensor, spheres: Optional[torch.Tensor] = None):
    """Analytic (rgb, sigma) at world points (..., 3).

    Density: smooth bump per sphere, dens * sigmoid(8*(1 - d/r));
    color: density-weighted blend of sphere colors.
    """
    sp = torch.as_tensor(_SPHERES if spheres is None else spheres, device=pts.device)
    centers, radii = sp[:, 0:3], sp[:, 3]
    dens, colors = sp[:, 4], sp[:, 5:8]
    d = torch.linalg.vector_norm(pts[..., None, :] - centers, dim=-1)  # (..., K)
    contrib = dens * torch.sigmoid(8.0 * (1.0 - d / radii))  # (..., K)
    sigma = torch.sum(contrib, dim=-1, keepdim=True)
    w = contrib / torch.clamp(sigma, min=1e-8)
    # Blend as f32 products and sums (never a TF32 matmul).
    rgb = torch.sum(w[..., :, None] * colors, dim=-2)
    return rgb, sigma


def look_at_pose(eye: np.ndarray, target=np.zeros(3), up=np.array([0.0, 0.0, 1.0])):
    """NeRF-convention c2w (camera looks along -z)."""
    eye = np.asarray(eye, np.float32)
    backward = eye - target
    backward = backward / np.linalg.norm(backward)  # camera +z
    right = np.cross(up, backward)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(backward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, cam_up, backward, eye
    return c2w


def hemisphere_poses(n: int = N_POSES, radius: float = RADIUS) -> np.ndarray:
    """Evenly spiraling poses over the upper hemisphere (deterministic)."""
    golden = (1 + 5**0.5) / 2
    poses = []
    for k in range(n):
        elev = np.arcsin(0.15 + 0.8 * (k + 0.5) / n)  # avoid poles/equator
        azim = 2 * np.pi * ((k / golden) % 1.0)
        eye = radius * np.array(
            [np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)]
        )
        poses.append(look_at_pose(eye))
    return np.stack(poses).astype(np.float32)


@torch.no_grad()
def render_ground_truth(
    pose: torch.Tensor,
    n_samples: int = GT_SAMPLES,
    h: int = H,
    w: int = W,
    focal: Optional[float] = None,
    chunk: int = 20000,
) -> torch.Tensor:
    """Reference-quality (h, w, 3) render of the analytic field for one
    pose, on the pose's device, chunked over rays."""
    focal = focal if focal is not None else FOCAL * (h / H)
    rays_o, rays_d = get_rays(h, w, focal, pose)
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=rays_o.device)
    z1 = NEAR * (1.0 - t) + FAR * t
    out = []
    for c in range(0, h * w, chunk):
        ro, rd = rays_o[c:c + chunk], rays_d[c:c + chunk]
        z = z1.expand(ro.shape[0], n_samples)
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        rgb, sigma = field(pts)
        comp, _, _, _ = volume_render(rgb, sigma, z, rd, white_bkgd=True)
        out.append(comp)
    return torch.clamp(torch.cat(out), 0.0, 1.0).reshape(h, w, 3)


def generate_synthetic_dataset(
    n_poses: int = N_POSES, h: int = H, w: int = W, device="cpu"
) -> Dict[str, np.ndarray]:
    """Dataset dict {images, poses, focal} with the npz schema (numpy)."""
    focal = FOCAL * (h / H)
    poses = hemisphere_poses(n_poses)
    images = np.stack(
        [
            render_ground_truth(torch.from_numpy(p).to(device), h=h, w=w, focal=focal).cpu().numpy()
            for p in poses
        ]
    ).astype(np.float32)
    return {"images": images, "poses": poses, "focal": np.float32(focal)}
