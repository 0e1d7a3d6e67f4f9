"""Stratified depth sampling along rays.

Port of tinynerf_tpu/ops/sampling.py:28-71:
z = near*(1-t) + far*t with t = linspace(0,1,n); when randomized, each
bin [lower_i, upper_i] (edges at the midpoints) gets one uniform draw.
The draws come from an explicit torch.Generator.
"""

from __future__ import annotations

from typing import Optional

import torch


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
