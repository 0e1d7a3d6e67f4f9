"""Procedural synthetic NeRF dataset (offline stand-in for tiny_nerf_data.npz).

Port of tinynerf_tpu/synthetic.py: an analytic emission/absorption
field, ground truth rendered with the same volume-rendering equation
(dense 256-sample quadrature). Two scenes:
- "spheres": colored soft-edged spheres, the fixed cluster or, with an
  int seed, a randomized one (random_spheres, the multi-scene seeds);
- "lattice": the hard scene, a cube wireframe of thin striped capsules
  with face diagonals, a trig-textured central ball and a thin checkered
  floor slab (field_lattice): thin structures and high-frequency
  texture, on a mostly white background.
Camera geometry mimics the real dataset: 106 poses on the upper
hemisphere at radius ~4.03 looking at the origin, 100x100 images, focal
~138.9 px; or (forward_facing=True, the --ndc scene) an LLFF-style
one-sided capture. Scene parameters and poses are made with numpy,
exactly as in the JAX package; the images are rendered with torch on the
requested device, every field operation in float32 in the JAX order
(accurate sin: the lattice's stripes take arguments up to 40 rad, and
its capsules' sigmoid of sharpness 24 turns d/r rounding into colour).

    python -m tinynerf_tpu_torch.synthetic --out data/hard_scene.npz --scene lattice \
        [--n-poses 106] [--h 100] [--w 100] [--forward-facing] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
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


def _warm_cpu_math(device: torch.device) -> None:
    """One single-threaded transcendental call before the first
    multi-threaded one. The first multi-threaded torch.sin of a CPU
    process can return inaccurate values (seen with torch 2.13 on AVX512,
    in some processes only; every later call is accurate), and the
    lattice's stripes read sin at arguments up to 64 rad."""
    if device.type == "cpu":
        torch.sin(torch.zeros(1))


def random_spheres(seed: int, n_spheres: int = 8) -> np.ndarray:
    """Randomized sphere-cluster parameters (n_spheres, 8), the rows of
    _SPHERES: each seed is a distinct scene (np.random.RandomState, so the
    JAX package's scene bit for bit)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.55, 0.55, (n_spheres, 3))
    radii = rng.uniform(0.18, 0.45, (n_spheres, 1))
    dens = rng.uniform(25.0, 45.0, (n_spheres, 1))
    colors = rng.uniform(0.05, 0.95, (n_spheres, 3))
    return np.concatenate([centers, radii, dens, colors], axis=1).astype(np.float32)


def field(pts: torch.Tensor, spheres: Optional[torch.Tensor] = None):
    """Analytic (rgb, sigma) at world points (..., 3).

    Density: smooth bump per sphere, dens * sigmoid(8*(1 - d/r));
    color: density-weighted blend of sphere colors.
    """
    sp = torch.as_tensor(_SPHERES if spheres is None else spheres, dtype=torch.float32,
                         device=pts.device)
    centers, radii = sp[:, 0:3], sp[:, 3]
    dens, colors = sp[:, 4], sp[:, 5:8]
    d = torch.linalg.vector_norm(pts[..., None, :] - centers, dim=-1)  # (..., K)
    contrib = dens * torch.sigmoid(8.0 * (1.0 - d / radii))  # (..., K)
    sigma = torch.sum(contrib, dim=-1, keepdim=True)
    w = contrib / torch.clamp(sigma, min=1e-8)
    # Blend as f32 products and sums (never a TF32 matmul).
    rgb = torch.sum(w[..., :, None] * colors, dim=-2)
    return rgb, sigma


# The hard scene ("lattice"): a cube wireframe of thin capsules (radius
# 0.035, ~1.2 px at the canonical camera) plus three face diagonals (no
# symmetry group explains the views), a stripe texture along every strut,
# a central ball with a 3-D trig texture at ~25 rad/unit and a thin
# textured floor slab.
_CUBE_HALF = 0.55


def _lattice_segments():
    """(a, b): the (15, 3) endpoints of the 12 cube edges and 3 face
    diagonals, in the JAX package's order."""
    c = _CUBE_HALF
    corners = np.array([[x, y, z] for x in (-c, c) for y in (-c, c) for z in (-c, c)], np.float32)
    edges = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.count_nonzero(np.abs(corners[i] - corners[j]) > 1e-6) == 1:
                edges.append((corners[i], corners[j]))
    edges.append((np.array([-c, -c, -c]), np.array([c, c, -c])))
    edges.append((np.array([-c, c, c]), np.array([c, -c, c])))
    edges.append((np.array([-c, -c, -c]), np.array([-c, c, c])))
    a = np.stack([e[0] for e in edges]).astype(np.float32)
    b = np.stack([e[1] for e in edges]).astype(np.float32)
    return a, b


_LAT_A, _LAT_B = _lattice_segments()
# Per-strut base colours: a deterministic palette with a strong hue spread.
_LAT_COLORS = np.stack([
    np.array([0.5 + 0.45 * np.sin(2.1 * k + 0.3),
              0.5 + 0.45 * np.sin(2.1 * k + 2.4),
              0.5 + 0.45 * np.sin(2.1 * k + 4.5)], np.float32)
    for k in range(len(_LAT_A))
])


def field_lattice(pts: torch.Tensor):
    """Analytic (rgb (..., 3), sigma (..., 1)) of the hard scene at world
    points (..., 3), float32."""
    dev = pts.device
    _warm_cpu_math(dev)
    a = torch.from_numpy(_LAT_A).to(dev)  # (K, 3)
    b = torch.from_numpy(_LAT_B).to(dev)
    colors = torch.from_numpy(_LAT_COLORS).to(dev)  # (K, 3)
    ab = b - a
    # Closest point on each segment: t = clamp(<p-a, ab>/|ab|^2, 0, 1).
    pa = pts[..., None, :] - a  # (..., K, 3)
    t = torch.clamp(torch.sum(pa * ab, dim=-1) / torch.sum(ab * ab, dim=-1), 0.0, 1.0)
    d = torch.linalg.vector_norm(pa - t[..., None] * ab, dim=-1)  # (..., K)
    strut_r = 0.035
    occ = torch.sigmoid(24.0 * (1.0 - d / strut_r))  # sharp capsule
    # Stripes along each strut, the phase varying per strut.
    stripe = 0.55 + 0.45 * torch.sin(
        40.0 * t + torch.arange(a.shape[0], dtype=torch.float32, device=dev) * 1.7)
    strut_contrib = 60.0 * occ  # (..., K)
    strut_rgb = colors * stripe[..., None]  # (..., K, 3)

    ball_d = torch.linalg.vector_norm(pts, dim=-1)
    ball_occ = torch.sigmoid(24.0 * (1.0 - ball_d / 0.30))
    tex = (0.5 + 0.25 * torch.sin(25.0 * pts[..., 0]) * torch.sin(25.0 * pts[..., 1])
           + 0.25 * torch.sin(25.0 * pts[..., 2]))
    ball_rgb = torch.stack([tex, 0.35 + 0.3 * (1.0 - tex), 0.25 + 0.5 * tex], dim=-1)
    ball_contrib = 50.0 * ball_occ

    # Floor slab of half-thickness 0.02 (~0.7 px) with a checker.
    slab = (torch.sigmoid(24.0 * (1.0 - torch.abs(pts[..., 2] + 0.45) / 0.02))
            * torch.sigmoid(12.0 * (0.5 - torch.abs(pts[..., 0])))
            * torch.sigmoid(12.0 * (0.5 - torch.abs(pts[..., 1]))))
    checker = 0.5 + 0.5 * torch.sin(30.0 * pts[..., 0]) * torch.sin(30.0 * pts[..., 1])
    slab_rgb = torch.stack([0.2 + 0.7 * checker, 0.2 + 0.7 * checker, 0.9 - 0.6 * checker], dim=-1)
    slab_contrib = 55.0 * slab

    contrib = torch.cat([strut_contrib, ball_contrib[..., None], slab_contrib[..., None]], dim=-1)
    rgb_all = torch.cat([strut_rgb, ball_rgb[..., None, :], slab_rgb[..., None, :]], dim=-2)
    sigma = torch.sum(contrib, dim=-1, keepdim=True)
    w = contrib / torch.clamp(sigma, min=1e-8)
    rgb = torch.sum(w[..., None] * rgb_all, dim=-2)
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


def forward_facing_poses(n: int = 20, distance: float = 2.2, spread: float = 0.5,
                         seed: int = 0) -> np.ndarray:
    """LLFF-style forward-facing capture: cameras clustered on the +z side
    of the scene, all looking toward the origin, so every ray has dz < 0
    (the precondition of ops/rays.ndc_rays). distance 2.2 puts the sphere
    cluster at camera depth ~1.5-3, NDC t ~0.3-0.7 (near plane 1.0).
    np.random.RandomState(seed) draws the eyes, as in
    tinynerf_tpu/synthetic.py:220-247, so the poses match bit for bit."""
    rng = np.random.RandomState(seed)
    poses = []
    for _ in range(n):
        eye = np.array(
            [
                spread * (rng.rand() - 0.5) * 2.0,
                spread * (rng.rand() - 0.5) * 2.0,
                distance + 0.4 * (rng.rand() - 0.5),
            ]
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
    spheres: Optional[np.ndarray] = None,
    chunk: int = 20000,
    scene: str = "spheres",
) -> torch.Tensor:
    """Reference-quality (h, w, 3) render of the analytic field for one
    pose, on the pose's device, chunked over rays: the sphere cluster
    (`spheres`, default the fixed one) or, with scene="lattice", the hard
    scene."""
    focal = focal if focal is not None else FOCAL * (h / H)
    rays_o, rays_d = get_rays(h, w, focal, pose)
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=rays_o.device)
    z1 = NEAR * (1.0 - t) + FAR * t
    if scene == "lattice":
        field_fn = field_lattice
    else:
        sp = torch.as_tensor(_SPHERES if spheres is None else spheres, dtype=torch.float32,
                             device=rays_o.device)

        def field_fn(p):
            return field(p, sp)

    out = []
    for c in range(0, h * w, chunk):
        ro, rd = rays_o[c:c + chunk], rays_d[c:c + chunk]
        z = z1.expand(ro.shape[0], n_samples)
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        rgb, sigma = field_fn(pts)
        comp, _, _, _ = volume_render(rgb, sigma, z, rd, white_bkgd=True)
        out.append(comp)
    return torch.clamp(torch.cat(out), 0.0, 1.0).reshape(h, w, 3)


def generate_synthetic_dataset(
    n_poses: int = N_POSES,
    h: int = H,
    w: int = W,
    seed: Optional[int] = None,
    forward_facing: bool = False,
    scene: str = "spheres",
    device="cpu",
) -> Dict[str, np.ndarray]:
    """Dataset dict {images, poses, focal} with the npz schema (numpy),
    rendered on `device`.

    seed=None renders the fixed sphere cluster; an int seed a randomized
    one (random_spheres(seed)). forward_facing=True takes
    forward_facing_poses (seeded by `seed`, 0 without one) instead of the
    hemisphere orbit: the --ndc training scene, its ground truth still
    rendered in world space (NDC is a training-time reparameterization).
    scene="lattice" renders the hard scene instead of the spheres."""
    if scene not in ("spheres", "lattice"):
        raise ValueError(f"scene={scene!r} (expected 'spheres'|'lattice')")
    focal = FOCAL * (h / H)
    spheres = _SPHERES if seed is None else random_spheres(seed)
    poses = (forward_facing_poses(n_poses, seed=0 if seed is None else seed) if forward_facing
             else hemisphere_poses(n_poses))
    images = np.stack([
        render_ground_truth(torch.from_numpy(p).to(device), h=h, w=w, focal=focal, spheres=spheres,
                            scene=scene).cpu().numpy()
        for p in poses
    ]).astype(np.float32)
    return {"images": images, "poses": poses, "focal": np.float32(focal)}


@dataclasses.dataclass
class GenConfig:
    """Flags of `python -m tinynerf_tpu_torch.synthetic` (the JAX package's
    GenConfig, tinynerf_tpu/synthetic.py:341-353, and the device to
    render on)."""

    out: str = "data/synthetic.npz"
    scene: str = "spheres"
    n_poses: int = N_POSES
    h: int = H
    w: int = W
    forward_facing: bool = False
    device: str = "cuda"


def _cli(argv=None):
    """Write a synthetic dataset npz (the module docstring's command)."""
    from tinynerf_tpu_torch.utils.cli import cli as parse_cli

    cfg = parse_cli(GenConfig, description=__doc__, args=argv)
    d = generate_synthetic_dataset(n_poses=cfg.n_poses, h=cfg.h, w=cfg.w,
                                   forward_facing=cfg.forward_facing, scene=cfg.scene,
                                   device=cfg.device)
    os.makedirs(os.path.dirname(cfg.out) or ".", exist_ok=True)
    np.savez(cfg.out, images=d["images"], poses=d["poses"], focal=d["focal"])
    print(f"[synthetic] wrote {cfg.out}: scene={cfg.scene} images {d['images'].shape} "
          f"focal {float(d['focal']):.2f}")


if __name__ == "__main__":
    _cli()
