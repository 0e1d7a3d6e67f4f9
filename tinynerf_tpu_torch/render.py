"""Full-image rendering: the encode->MLP->composite chain over ray chunks.

Port of tinynerf_tpu/render.py:30-430 (TinyNeRF, the full NeRF's
hierarchical renderer, the occupancy-proposal renderer and the grid
family's renderer). Rays for a pose are processed in fixed-size chunks
(default 8192) with un-jittered samples; chunking never changes the
result (rays are independent). PyTorch runs eagerly, so the chunk loop
is a Python loop; the chunk shapes stay those of the JAX package (the
128-aligned shrink and unit-z padding of the last chunk), which is what
the fused kernels see on the card.

ndc=True reprojects each pose's rays to NDC space (ops/rays.ndc_rays,
near plane 1.0) before the chunks; the caller samples near=0, far=1.
aux=True renders the geometry instead of the colour: the packed (depth,
acc) pseudo-image of pack_aux, always through the eager path, as in the
JAX package (the fused render kernels composite colour only). The frames
variants loop over the poses.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tinynerf_tpu_torch.models.nerf import NeRFConfig, render_rays_hierarchical
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.rays import get_rays, ndc_rays, pad_rays
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render
from tinynerf_tpu_torch.utils.profiling import span


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


def pack_aux(depth: torch.Tensor, acc: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """Per-ray (depth, acc) as an (R, 3) pseudo-image for the colour
    driver (tinynerf_tpu/render.py:68-83): channel 0 the expected
    termination depth depth / max(acc, 1e-6) normalised over [near, far],
    channel 1 the opacity acc, channel 2 zero. Low-acc rays carry an
    ill-defined depth: consumers mask on acc. (R,) and (R, 1) inputs pack
    alike."""
    depth, acc = depth.reshape(-1), acc.reshape(-1)
    d_exp = depth / torch.clamp(acc, min=1e-6)
    d_norm = (d_exp - near) / (far - near)
    return torch.stack([d_norm, acc, torch.zeros_like(acc)], dim=-1)


def unpack_aux(img, near: float, far: float):
    """(H, W, 3) aux pseudo-image -> (expected depth (H, W) in scene units,
    inside [near, far] by the driver's clip; acc (H, W))."""
    return img[..., 0] * (far - near) + near, img[..., 1]


def chunked_over_rays(ray_fn, H: int, W: int, focal, pose: torch.Tensor, chunk: int,
                      ndc: bool = False):
    """Pad H*W rays to a chunk multiple, run `ray_fn(ro, rd) -> (chunk, 3)`
    over the chunks, un-pad and reshape to an (H, W, 3) image in [0, 1].
    ndc=True reprojects the rays to NDC space first (near plane 1.0).
    Spans: view, and in it view.rays and one view.chunk a chunk
    (utils/profiling.py)."""
    with span("view"):
        with span("view.rays"):
            rays_o, rays_d = get_rays(H, W, focal, pose)
            if ndc:
                rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
            hw = H * W
            # Shrink the chunk to the 128-aligned cover of H*W when the image is
            # smaller than the requested chunk budget.
            chunk = min(chunk, -(-hw // 128) * 128)
            n_chunks = -(-hw // chunk)
            rays_o, rays_d = pad_rays(rays_o, rays_d, n_chunks * chunk - hw)
        outs = []
        for c in range(n_chunks):
            with span("view.chunk"):
                outs.append(ray_fn(rays_o[c * chunk:(c + 1) * chunk],
                                   rays_d[c * chunk:(c + 1) * chunk]))
        return torch.clamp(torch.cat(outs)[:hw].reshape(H, W, 3), 0.0, 1.0)


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
    ndc: bool = False,
    aux: bool = False,
) -> torch.Tensor:
    """Render a full (H, W, 3) image for one camera pose, on the device
    of `params`; aux=True renders the packed (depth, acc) pseudo-image
    (pack_aux) through the eager path."""
    device = next(params.parameters()).device
    pose = torch.as_tensor(pose, dtype=torch.float32).to(device)

    def one_chunk(ro, rd):
        if aux:
            n_rays = ro.shape[0]
            z_vals, pts = stratified_samples(near, far, n_samples, ro, rd, randomized=False)
            xenc = positional_encoding(pts.reshape(-1, 3), num_freqs=num_freqs)
            rgb, sigma = params(xenc, model_cfg)
            _, depth, acc, _ = volume_render(rgb.reshape(n_rays, n_samples, 3),
                                             sigma.reshape(n_rays, n_samples), z_vals, rd,
                                             white_bkgd=white_bkgd)
            return pack_aux(depth, acc, near, far)
        return render_rays(
            params, ro, rd, n_samples=n_samples, near=near, far=far,
            num_freqs=num_freqs, white_bkgd=white_bkgd, model_cfg=model_cfg,
            use_fused=use_fused,
        )

    return chunked_over_rays(one_chunk, H, W, focal, pose, chunk, ndc=ndc)


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
    ndc: bool = False,
    aux: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer, or with frames=True the
    batched `(params, poses (F, 4, 4)) -> (F, H, W, 3)` variant (a loop
    over the poses); aux=True renders the packed (depth, acc) channels."""
    fn = functools.partial(
        render_image_fn, H=H, W=W, focal=float(focal), chunk=chunk,
        n_samples=n_samples, near=near, far=far, num_freqs=num_freqs,
        white_bkgd=white_bkgd, model_cfg=model_cfg, use_fused=use_fused, ndc=ndc, aux=aux,
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
    ndc: bool = False,
    aux: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer for the full NeRF: the fine
    composite of the deterministic coarse -> resample -> fine pipeline is
    the image (port of tinynerf_tpu/render.py:201-272). use_fused routes
    both passes through the fused kernels (kernels/fused_nerf.py);
    otherwise the eager models/nerf.render_rays_hierarchical runs.
    aux=True renders the fine pass's packed (depth, acc) channels through
    the eager path. frames=True returns the batched `(params, poses (F, 4,
    4)) -> (F, H, W, 3)` variant."""
    nerf_cfg = nerf_cfg or NeRFConfig()
    kw = dict(n_coarse=n_coarse, n_fine=n_fine, near=near, far=far, white_bkgd=white_bkgd,
              cfg=nerf_cfg)

    @torch.no_grad()
    def fn(params, pose):
        device = next(params.parameters()).device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(device)

        def one_chunk(ro, rd):
            if aux:
                _, _, depth, acc = render_rays_hierarchical(params, ro, rd, return_aux=True, **kw)
                return pack_aux(depth, acc, near, far)
            if use_fused:
                from tinynerf_tpu_torch.kernels.fused_nerf import fused_render_rays_hierarchical

                return fused_render_rays_hierarchical(params, ro, rd, **kw)[1]
            return render_rays_hierarchical(params, ro, rd, **kw)[1]

        return chunked_over_rays(one_chunk, H, W, float(focal), pose, chunk, ndc=ndc)

    return _frames(fn) if frames else fn


def make_occupancy_image_renderer(
    *,
    H: int,
    W: int,
    focal: float,
    chunk: int = 4096,
    n_samples: int = 192,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    nerf_cfg=None,
    use_fused: bool = False,
    frames: bool = False,
    ndc: bool = False,
    resolution: int = 64,
    n_segments: int = 64,
    floor: float = 1e-2,
    aabb=None,
    aux: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer for the occupancy-proposal
    NeRF (params: a NeRF(parts=("fine",))), port of
    tinynerf_tpu/render.py:275-353: the density grid is rebuilt from the
    MLP once per image, outside the chunk loop, then every chunk draws
    n_samples depths from it (ops/occupancy.occupancy_samples, no jitter)
    and runs the one MLP: through K5 with use_fused
    (kernels/fused_nerf_stream.fused_nerf_render_rays_streamed, blocks of
    pick_sample_block(n_samples)), else eagerly; aux=True renders the
    packed (depth, acc) channels through the eager path."""
    from tinynerf_tpu_torch.models.nerf import run_mlp, view_encoding
    from tinynerf_tpu_torch.ops.occupancy import density_grid, occupancy_samples

    nerf_cfg = nerf_cfg or NeRFConfig()

    @torch.no_grad()
    def fn(params, pose):
        device = next(params.parameters()).device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(device)
        grid = density_grid(params.fine, nerf_cfg, resolution=resolution, aabb=aabb)

        def one_chunk(ro, rd):
            z = occupancy_samples(grid, ro, rd, near, far, n_samples, n_segments=n_segments,
                                  floor=floor, aabb=aabb, randomized=False)
            if use_fused and not aux:
                from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
                    fused_nerf_render_rays_streamed,
                    pick_sample_block,
                )

                return fused_nerf_render_rays_streamed(
                    params.fine, ro, rd, z, white_bkgd=white_bkgd, cfg=nerf_cfg,
                    sample_block=pick_sample_block(z.shape[1]))
            pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
            rgb, sigma = run_mlp(params.fine, pts, view_encoding(rd, nerf_cfg), nerf_cfg)
            comp, depth, acc, _ = volume_render(rgb, sigma, z, rd, white_bkgd=white_bkgd)
            return pack_aux(depth, acc, near, far) if aux else comp

        return chunked_over_rays(one_chunk, H, W, float(focal), pose, chunk, ndc=ndc)

    return _frames(fn) if frames else fn


def make_grid_image_renderer(
    *,
    H: int,
    W: int,
    focal: float,
    grid_cfg,
    chunk: int = 8192,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    frames: bool = False,
    ndc: bool = False,
    aux: bool = False,
):
    """`(params, pose) -> (H, W, 3)` renderer for the grid family (params: a
    models/grid_nerf.GridNeRF), port of tinynerf_tpu/render.py:356-386:
    one deterministic stratified pass a chunk (models/grid_nerf.
    render_rays_grid: the encoding's forward kernel, the rest eager
    torch); aux=True renders the packed (depth, acc) channels; frames=True
    returns the batched `(params, poses (F, 4, 4)) -> (F, H, W, 3)`
    variant."""
    from tinynerf_tpu_torch.models.grid_nerf import render_rays_grid

    @torch.no_grad()
    def fn(params, pose):
        device = next(params.parameters()).device
        pose = torch.as_tensor(pose, dtype=torch.float32).to(device)

        def one_chunk(ro, rd):
            comp, depth, acc, _, _ = render_rays_grid(params, ro, rd, None, cfg=grid_cfg,
                                                      n_samples=n_samples, near=near, far=far,
                                                      white_bkgd=white_bkgd)
            return pack_aux(depth, acc, near, far) if aux else comp

        return chunked_over_rays(one_chunk, H, W, float(focal), pose, chunk, ndc=ndc)

    return _frames(fn) if frames else fn
