"""Full-image rendering: the encode->MLP->composite chain over ray chunks.

Port of tinynerf_tpu/render.py:30-184, 201-272, 393-430 (TinyNeRF and
the full NeRF's hierarchical renderer). Rays for a pose are
processed in fixed-size chunks (default 8192) with un-jittered
stratified samples; chunking never changes the result (rays are
independent). PyTorch runs eagerly, so the chunk loop is a Python loop;
the chunk shapes stay those of the JAX package (the 128-aligned shrink
and unit-z padding of the last chunk), which is what the fused kernel
sees on the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tinynerf_tpu_torch.models.nerf import NeRFConfig, render_rays_hierarchical
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.rays import get_rays
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render


def render_rays(
    params: TinyNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    use_fused: bool = False,
) -> torch.Tensor:
    """Deterministically render a batch of rays to composite RGB (R, 3).

    use_fused routes through the fused CUDA kernel
    (kernels/fused_render.py); otherwise the eager composition of the
    ops and the model runs."""
    kw = dict(n_samples=n_samples, near=near, far=far, num_freqs=num_freqs,
              white_bkgd=white_bkgd, model_cfg=model_cfg)
    if use_fused:
        from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays

        return fused_render_rays(params, rays_o, rays_d, **kw)
    n_rays = rays_o.shape[0]
    z_vals, pts = stratified_samples(near, far, n_samples, rays_o, rays_d, randomized=False)
    xenc = positional_encoding(pts.reshape(-1, 3), num_freqs=num_freqs)
    rgb, sigma = params(xenc, model_cfg)
    rgb = rgb.reshape(n_rays, n_samples, 3)
    sigma = sigma.reshape(n_rays, n_samples)
    comp_rgb, _, _, _ = volume_render(rgb, sigma, z_vals, rays_d, white_bkgd=white_bkgd)
    return comp_rgb


def chunked_over_rays(ray_fn, H: int, W: int, focal, pose: torch.Tensor, chunk: int):
    """Pad H*W rays to a chunk multiple, run `ray_fn(ro, rd) -> (chunk, 3)`
    over the chunks, un-pad and reshape to an (H, W, 3) image in [0, 1]."""
    rays_o, rays_d = get_rays(H, W, focal, pose)
    hw = H * W
    # Shrink the chunk to the 128-aligned cover of H*W when the image is
    # smaller than the requested chunk budget.
    chunk = min(chunk, -(-hw // 128) * 128)
    n_chunks = -(-hw // chunk)
    pad = n_chunks * chunk - hw
    rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
    # Pad directions with unit z so norms stay finite for padded rays.
    unit_z = torch.tensor([[0.0, 0.0, 1.0]], device=rays_d.device)
    rays_d = torch.cat([rays_d, unit_z.expand(pad, 3)])
    out = torch.cat(
        [
            ray_fn(rays_o[c * chunk:(c + 1) * chunk], rays_d[c * chunk:(c + 1) * chunk])
            for c in range(n_chunks)
        ]
    )
    return torch.clamp(out[:hw].reshape(H, W, 3), 0.0, 1.0)


@torch.no_grad()
def render_image_fn(
    params: TinyNeRF,
    pose: torch.Tensor,
    *,
    H: int,
    W: int,
    focal: float,
    chunk: int = 8192,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    use_fused: bool = False,
) -> torch.Tensor:
    """Render a full (H, W, 3) image for one camera pose, on the device
    of `params`."""
    device = next(params.parameters()).device
    pose = torch.as_tensor(pose, dtype=torch.float32).to(device)

    def one_chunk(ro, rd):
        return render_rays(
            params, ro, rd, n_samples=n_samples, near=near, far=far,
            num_freqs=num_freqs, white_bkgd=white_bkgd, model_cfg=model_cfg,
            use_fused=use_fused,
        )

    return chunked_over_rays(one_chunk, H, W, focal, pose, chunk)


def make_image_renderer(
    *,
    H: int,
    W: int,
    focal: float,
    chunk: int = 8192,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    use_fused: bool = False,
    frames: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer, or with frames=True the
    batched `(params, poses (F, 4, 4)) -> (F, H, W, 3)` variant (a loop
    over the poses)."""
    fn = functools.partial(
        render_image_fn, H=H, W=W, focal=float(focal), chunk=chunk,
        n_samples=n_samples, near=near, far=far, num_freqs=num_freqs,
        white_bkgd=white_bkgd, model_cfg=model_cfg, use_fused=use_fused,
    )
    return _frames(fn) if frames else fn


def _frames(fn):
    """`(params, pose) -> image` -> `(params, poses (F, 4, 4)) -> (F, H, W, 3)`."""
    return lambda params, poses: torch.stack([fn(params, p) for p in poses])


def make_hierarchical_image_renderer(
    *,
    H: int,
    W: int,
    focal: float,
    chunk: int = 4096,
    n_coarse: int = 64,
    n_fine: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    nerf_cfg=None,
    use_fused: bool = False,
    frames: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer for the full NeRF: the fine
    composite of the deterministic coarse -> resample -> fine pipeline is
    the image (port of tinynerf_tpu/render.py:201-272, colour only).
    use_fused routes both passes through the fused kernels
    (kernels/fused_nerf.py); otherwise the eager
    models/nerf.render_rays_hierarchical runs. frames=True returns the
    batched `(params, poses (F, 4, 4)) -> (F, H, W, 3)` variant."""
    nerf_cfg = nerf_cfg or NeRFConfig()
    kw = dict(n_coarse=n_coarse, n_fine=n_fine, near=near, far=far, white_bkgd=white_bkgd,
              cfg=nerf_cfg)

    @torch.no_grad()
    def fn(params, pose):
        device = next(params.parameters()).device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(device)

        def one_chunk(ro, rd):
            if use_fused:
                from tinynerf_tpu_torch.kernels.fused_nerf import fused_render_rays_hierarchical

                return fused_render_rays_hierarchical(params, ro, rd, **kw)[1]
            return render_rays_hierarchical(params, ro, rd, **kw)[1]

        return chunked_over_rays(one_chunk, H, W, float(focal), pose, chunk)

    return _frames(fn) if frames else fn
