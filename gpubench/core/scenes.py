"""The benchmark's scenes and cameras, made from the seed on the device.

A frozen copy of the synthetic sphere-cluster scene the repository trains
on (an analytic emission-absorption field of 8 soft spheres, its ground
truth rendered by the rendering equation with 256 samples a ray), the
106 hemisphere poses at radius 4.03 that mimic the Blender captures, and
the 60-frame spiral of novel views around one of them. The focal length
scales with the image size (138.89 px at 100 x 100). Nothing here imports
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpubench.reference.common import composite, linspace_depths, pinhole_rays

FOCAL_100 = 138.88887889922103
RADIUS = 4.0311289
NEAR, FAR = 2.0, 6.0
GT_SAMPLES = 256


def focal(size: int) -> float:
    return FOCAL_100 * (size / 100.0)


def random_spheres(seed: int, n_spheres: int = 8) -> np.ndarray:
    """(n_spheres, 8) rows of centre xyz, radius, density, rgb."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.55, 0.55, (n_spheres, 3))
    radii = rng.uniform(0.18, 0.45, (n_spheres, 1))
    dens = rng.uniform(25.0, 45.0, (n_spheres, 1))
    colors = rng.uniform(0.05, 0.95, (n_spheres, 3))
    return np.concatenate([centers, radii, dens, colors], axis=1).astype(np.float32)


def sphere_field(pts: torch.Tensor, spheres: torch.Tensor):
    """Density sum_k dens_k * sigmoid(8 (1 - d_k / r_k)) and the
    density-weighted blend of the sphere colours at points (..., 3)."""
    d = torch.linalg.vector_norm(pts[..., None, :] - spheres[:, 0:3], dim=-1)
    contrib = spheres[:, 4] * torch.sigmoid(8.0 * (1.0 - d / spheres[:, 3]))
    sigma = contrib.sum(dim=-1)
    w = contrib / sigma.clamp(min=1e-8)[..., None]
    return (w[..., :, None] * spheres[:, 5:8]).sum(dim=-2), sigma


def look_at(eye: np.ndarray) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    back = eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 0.0, 1.0]), back)
    right = right / np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(back, right), back, eye
    return c2w


def hemisphere_poses(n: int) -> np.ndarray:
    """n poses spiralling over the upper hemisphere, looking at the origin."""
    golden = (1 + 5 ** 0.5) / 2
    out = []
    for k in range(n):
        elev = np.arcsin(0.15 + 0.8 * (k + 0.5) / n)
        azim = 2 * np.pi * ((k / golden) % 1.0)
        out.append(look_at(RADIUS * np.array([np.cos(elev) * np.cos(azim),
                                              np.cos(elev) * np.sin(azim), np.sin(elev)])))
    return np.stack(out).astype(np.float32)


def spiral_poses(c2w: np.ndarray, n_frames: int, radius: float) -> np.ndarray:
    """n_frames poses on a circle of `radius` in the camera's own xy plane."""
    out = []
    for t in np.linspace(0.0, 2.0 * math.pi, n_frames):
        T = np.eye(4)
        T[0, 3], T[1, 3] = radius * math.cos(t), radius * math.sin(t)
        out.append(c2w.astype(np.float64) @ T)
    return np.stack(out).astype(np.float32)


@torch.no_grad()
def render_truth(spheres: torch.Tensor, c2w: torch.Tensor, size: int, chunk: int = 40000):
    """The field's image (size * size, 3) from pose c2w, 256 samples a ray."""
    ro, rd = pinhole_rays(size, focal(size), c2w)
    out = []
    for c in range(0, ro.shape[0], chunk):
        o, d = ro[c:c + chunk], rd[c:c + chunk]
        z = linspace_depths(o.shape[0], GT_SAMPLES, NEAR, FAR, o.device)
        rgb, sigma = sphere_field(o[:, None, :] + d[:, None, :] * z[..., None], spheres)
        out.append(composite(rgb, sigma, z, d)[0])
    return torch.cat(out).clamp(0.0, 1.0)


@torch.no_grad()
def training_scenes(scene_seeds, n_views: int, size: int, device) -> dict:
    """rays_o, rays_d, pixels (K, n_views, size * size, 3): scene k a
    sphere cluster of seed scene_seeds[k] seen from n_views hemisphere
    poses."""
    poses = torch.from_numpy(hemisphere_poses(n_views)).to(device)
    ro, rd, px = [], [], []
    for s in scene_seeds:
        spheres = torch.from_numpy(random_spheres(int(s))).to(device)
        rays = [pinhole_rays(size, focal(size), p) for p in poses]
        ro.append(torch.stack([r[0] for r in rays]))
        rd.append(torch.stack([r[1] for r in rays]))
        px.append(torch.stack([render_truth(spheres, p, size) for p in poses]))
    return {"rays_o": torch.stack(ro).contiguous(), "rays_d": torch.stack(rd).contiguous(),
            "pixels": torch.stack(px).contiguous()}
