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

The blockwise composite (port of :78-173) splits the sample axis into
blocks that each summarize to T (block transmittance), C, D and A (the
block-local colour, depth and opacity sums); blocks combine through the
exclusive product of the T's. parallel/train.py shards the sample axis
over processes with it, and kernels/fused_partials.py (K7) emits the same
summaries from a fused MLP pass.
"""

from __future__ import annotations

from typing import Dict

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


def composite_block_partials(rgb, sigma, z_vals, deltas, return_weights: bool = False):
    """Summarize one sample block per ray.

    rgb (..., S_blk, 3); sigma, z_vals, deltas (..., S_blk). deltas must
    be the global deltas sliced to this block (they depend on the next
    block's first z and the 1e10 terminal delta). return_weights also
    returns the block-local weights (..., S_blk): alpha times the
    within-block transmittance.

    Returns {"T": (...), "C": (..., 3), "D": (...), "A": (...)} [, weights].
    """
    rgb = rgb.float()
    sigma = sigma.float()
    alpha = 1.0 - torch.exp(-sigma * deltas)
    accum = torch.cumprod(1.0 - alpha + TRANS_EPS, dim=-1)
    trans = torch.cat([torch.ones_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    w = alpha * trans
    partials = {
        "T": accum[..., -1],
        "C": torch.sum(w[..., None] * rgb, dim=-2),
        "D": torch.sum(w * z_vals, dim=-1),
        "A": torch.sum(w, dim=-1),
    }
    if return_weights:
        return partials, w
    return partials


def combine_block_partials(partials: Dict[str, torch.Tensor], white_bkgd: bool = True):
    """Combine block summaries stacked on a leading block axis, front to
    back: T (B, ...), C (B, ..., 3), D (B, ...), A (B, ...) ->
    (comp_rgb (..., 3), depth (..., 1), acc (..., 1))."""
    T, C, D, A = partials["T"], partials["C"], partials["D"], partials["A"]
    cum = torch.cumprod(T, dim=0)
    lead = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)  # exclusive
    comp_rgb = torch.sum(lead[..., None] * C, dim=0)
    depth = torch.sum(lead * D, dim=0)[..., None]
    acc = torch.sum(lead * A, dim=0)[..., None]
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc)
    return comp_rgb, depth, acc


def global_deltas(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """(..., S) deltas with the 1e10 terminal and the ||d|| scaling."""
    z_vals = z_vals.float()
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], DELTA_INF)], dim=-1)
    return deltas * torch.linalg.vector_norm(rays_d.float(), dim=-1, keepdim=True)


def volume_render_blockwise(rgb, sigma, z_vals, rays_d, n_blocks: int, white_bkgd: bool = True):
    """volume_render's composite computed through n_blocks block partials
    (the semantic spec of the sharded and streamed paths) -> (comp_rgb,
    depth, acc)."""
    if sigma.dim() == rgb.dim():
        sigma = sigma[..., 0]
    S = z_vals.shape[-1]
    if S % n_blocks:
        raise ValueError(f"n_blocks={n_blocks} must divide n_samples={S}")
    sb = S // n_blocks
    deltas = global_deltas(z_vals, rays_d)
    blocks = [
        composite_block_partials(rgb[..., b * sb:(b + 1) * sb, :], sigma[..., b * sb:(b + 1) * sb],
                                 z_vals[..., b * sb:(b + 1) * sb], deltas[..., b * sb:(b + 1) * sb])
        for b in range(n_blocks)
    ]
    stacked = {k: torch.stack([blk[k] for blk in blocks]) for k in blocks[0]}
    return combine_block_partials(stacked, white_bkgd=white_bkgd)
