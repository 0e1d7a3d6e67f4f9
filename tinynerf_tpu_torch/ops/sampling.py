"""Stratified and inverse-CDF depth sampling along rays.

Port of tinynerf_tpu/ops/sampling.py:28-141:
z = near*(1-t) + far*t with t = linspace(0,1,n); when randomized, each
bin [lower_i, upper_i] (edges at the midpoints) gets one uniform draw.
sample_pdf draws the hierarchical samples. The draws come from an
explicit torch.Generator.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinynerf_tpu_torch.utils.profiling import spanned


def stratified_samples(
    near,
    far,
    n_samples: int,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
):
    """Sample n_samples depths in [near, far] per ray; optional jitter.

    Args:
      near, far: floats.
      n_samples: sample count.
      rays_o, rays_d: (N_rays, 3).
      randomized: when True, `generator` is required; its draws are
        made on the generator's device and moved to the rays' device.

    Returns:
      z_vals (N_rays, n_samples) float32, pts (N_rays, n_samples, 3).
    """
    n_rays = rays_o.shape[0]
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=rays_o.device)
    z_vals = (near * (1.0 - t_vals) + far * t_vals).expand(n_rays, n_samples)

    if randomized:
        if generator is None:
            raise ValueError("stratified_samples(randomized=True) requires a generator")
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        t_rand = torch.rand(
            z_vals.shape, generator=generator, dtype=torch.float32, device=generator.device
        ).to(z_vals.device)
        z_vals = lower + (upper - lower) * t_rand

    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return z_vals, pts


@spanned
def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    randomized: bool = True,
    generator: Optional[torch.Generator] = None,
    eps: float = 1e-5,
    stratified: bool = False,
) -> torch.Tensor:
    """Inverse-CDF sampling of `n_importance` depths from the piecewise
    PDF that `weights` (N, B) define over the sorted edges `bins`
    (N, B+1): the hierarchical ("fine") samples, sorted per ray.

    Port of tinynerf_tpu/ops/sampling.py:68-141. u is a deterministic
    linspace, or with randomized=True uniform draws from `generator`
    (stratified: u_i = (i + rand_i) / n). The JAX package's broadcast
    compare is a TPU formulation; torch.searchsorted finds the same
    bin: idx = #{cdf <= u}, below = idx - 1, above = min(idx, B).
    """
    n_rays, n_bins = weights.shape
    weights = weights + eps  # no NaN for a ray whose weights are all zero
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, B+1)

    if randomized:
        if generator is None:
            raise ValueError("sample_pdf(randomized=True) requires a generator")
        u = torch.rand(
            (n_rays, n_importance), generator=generator, dtype=torch.float32,
            device=generator.device,
        ).to(cdf.device)
        if stratified:
            strata = torch.arange(n_importance, dtype=torch.float32, device=cdf.device)
            u = (strata + u) / n_importance
    else:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=torch.float32, device=cdf.device)
        u = u.expand(n_rays, n_importance).contiguous()

    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=n_bins)
    cdf_below, cdf_above = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_below, bins_above = torch.gather(bins, 1, below), torch.gather(bins, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    samples = bins_below + t * (bins_above - bins_below)
    return torch.sort(samples, dim=-1).values
