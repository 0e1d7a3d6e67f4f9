"""Alpha-composite volume rendering (the NeRF rendering equation).

Port of tinynerf_tpu/ops/volume.py:25-75:
  deltas_i = z_{i+1} - z_i, last delta = 1e10, scaled by ||rays_d||
  alpha = 1 - exp(-sigma * delta)
  T_i = exclusive cumprod of (1 - alpha + 1e-10)
  weights = alpha * T; comp_rgb = sum w*rgb; depth = sum w*z; acc = sum w
  white background adds (1 - acc) to rgb when white_bkgd.

The composite always runs in float32, whatever dtype the MLP computed
in: exp(-sigma * 1e10) and the transmittance product are the
precision-sensitive part.
"""

from __future__ import annotations

import torch

DELTA_INF = 1e10
TRANS_EPS = 1e-10


def volume_render(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    white_bkgd: bool = True,
):
    """Composite per-sample (rgb, sigma) along each ray.

    Args:
      rgb:    (N_rays, N_samples, 3) in [0,1].
      sigma:  (N_rays, N_samples, 1) or (N_rays, N_samples), density >= 0.
      z_vals: (N_rays, N_samples) sample depths.
      rays_d: (N_rays, 3) ray directions (scales deltas by their norm).
      white_bkgd: add (1 - acc) white background to the composite.

    Returns:
      comp_rgb (N_rays, 3), depth (N_rays, 1), acc (N_rays, 1),
      weights (N_rays, N_samples).
    """
    rgb = rgb.float()
    z_vals = z_vals.float()
    if sigma.dim() == rgb.dim():
        sigma = sigma[..., 0]
    sigma = sigma.float()

    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], DELTA_INF)], dim=-1)
    deltas = deltas * torch.linalg.vector_norm(rays_d.float(), dim=-1, keepdim=True)

    alpha = 1.0 - torch.exp(-sigma * deltas)
    # Exclusive cumulative transmittance: prepend 1, drop the last term.
    accum = torch.cumprod(1.0 - alpha + TRANS_EPS, dim=-1)
    trans = torch.cat([torch.ones_like(accum[..., :1]), accum[..., :-1]], dim=-1)

    weights = alpha * trans
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1, keepdim=True)
    acc = torch.sum(weights, dim=-1, keepdim=True)

    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc)

    return comp_rgb, depth, acc, weights
