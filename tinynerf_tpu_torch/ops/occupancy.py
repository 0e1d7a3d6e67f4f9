"""Occupancy-grid proposal sampling: the sampler that replaces the coarse
MLP (port of tinynerf_tpu/ops/occupancy.py:47-398).

Per-ray depths are drawn by inverse-CDF over segment weights read from
a density grid of the scene box, so the MLP runs on one pass only: the
single `fine` MLP of a models/nerf.NeRF(parts=("fine",)). As in the JAX
package the grid is stateless: a pure function of the current MLP,
rebuilt once per training block and once per rendered image, never
checkpointed; its cell points are the cell centres, jittered inside the
cell by an explicit generator while training. Every ray draws the same
number of samples over a fixed number of segments, with an additive
weight floor so that space the grid believes empty is still visited.

- density_grid: sigma of the MLP at the (G, G, G) cell points, eager
  torch under no_grad (the JAX package's grid pass is a plain product
  outside any Pallas kernel). The sigma head is view-independent, so the
  direction encoding is that of +z.
- ray_segment_alphas, occupancy_samples: the per-segment occupancy
  alpha of the nearest cell at each segment's midpoint (0 outside the
  box), then ops/sampling.sample_pdf over the segments; the arithmetic
  keeps the JAX package's order (edges by its linspace formula,
  lo + u (hi - lo), (pts - lo) / (hi - lo), truncation to the cell
  index), so the nearest cell is the same one but where a point lies
  within f32 rounding of a cell face.
- make_occupancy_loss: the eager single-MLP loss on grid-proposed
  depths (autograd); make_occupancy_fused_grad_fn: its fused twin, the
  MLP's forward and backward through K6
  (kernels/fused_nerf_stream.fused_nerf_pass_grads_streamed) on the
  proposed depths, in blocks of pick_sample_block(S).
- make_occupancy_train_block: training.make_train_block's signature;
  per block one grid rebuild from the current parameters (the same on
  every rank: its generator ignores the rank), then the steps; with a
  data mesh the gradients are mean-reduced over the ranks. A mesh with a
  sample axis is refused: the proposal has no per-pass composite to
  shard.

Randomness: a step draws from training.step_generator (or, on a data
mesh, parallel/train.rank_generator) in this order: the ray batch
(training.draw_ray_batch), sample_pdf's u, then the sigma-noise (R, S)
when it is on. The grid's jitter comes from grid_generator(seed, step0).
The streams are not the JAX package's; the tests compare them
statistically.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.sampling import sample_pdf

DEFAULT_RESOLUTION = 64
DEFAULT_N_SEGMENTS = 64
DEFAULT_FLOOR = 1e-2
# Half-extent of the default box: the inward-facing capture (cameras at
# radius ~4, near 2, far 6) has its content inside |x| < 2.
DEFAULT_HALF_EXTENT = 3.0
# The grid jitter's salt: far outside any step or rank index, as the JAX
# package's fold_in tag (tinynerf_tpu/ops/occupancy.py:337-340).
_GRID_SALT = 0x0CC00000


def default_aabb(half_extent: float = DEFAULT_HALF_EXTENT, device=None) -> torch.Tensor:
    """(2, 3) float32 box [-h, h]^3."""
    return torch.tensor([[-half_extent] * 3, [half_extent] * 3], dtype=torch.float32,
                        device=device)


def aabb_from_rays(rays_o: torch.Tensor, rays_d: torch.Tensor, near: float, far: float,
                   margin: float = 0.05) -> torch.Tensor:
    """(2, 3) box covering every sample point any ray can produce: the
    [near, far] segment endpoints of every ray, widened by `margin` of the
    extent on each side. Deterministic given the data."""
    o = rays_o.reshape(-1, 3).float()
    d = rays_d.reshape(-1, 3).float()
    pts = torch.cat([o + d * near, o + d * far], dim=0)
    lo, hi = pts.min(dim=0).values, pts.max(dim=0).values
    pad = margin * (hi - lo)
    return torch.stack([lo - pad, hi + pad], dim=0)


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 linspace by jnp.linspace's formula: start (1 - i/div) +
    stop (i/div) for i < div, then stop itself (torch.linspace rounds
    otherwise)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


def grid_generator(seed: int, step0: int, device) -> torch.Generator:
    """The grid jitter's generator of the block starting at step0: the
    same on every rank."""
    from tinynerf_tpu_torch.training import mix_seed

    return torch.Generator(device=device).manual_seed(mix_seed(_GRID_SALT, seed, step0))


def _box(aabb, device) -> torch.Tensor:
    return (default_aabb() if aabb is None else torch.as_tensor(aabb, dtype=torch.float32)).to(device)


@torch.no_grad()
def density_grid(mlp, cfg, *, resolution: int = DEFAULT_RESOLUTION, aabb=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(G, G, G) sigma of `mlp` (a models/nerf.NeRFMLP) at the cell centres
    of the box, or at one point per cell jittered uniformly inside it by
    `generator` (tinynerf_tpu/ops/occupancy.py:82-116). No gradient."""
    dev = next(mlp.parameters()).device
    box = _box(aabb, dev)
    g = resolution
    lo, hi = box[0], box[1]
    centers = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    u = torch.stack(torch.meshgrid(centers, centers, centers, indexing="ij"), dim=-1).reshape(-1, 3)
    if generator is not None:
        jitter = torch.rand(u.shape, generator=generator, dtype=torch.float32,
                            device=generator.device).to(dev)
        u = u + (jitter - 0.5) / g
    pts = lo + u * (hi - lo)
    x_enc = positional_encoding(pts, num_freqs=cfg.num_freqs)
    d_enc = None
    if cfg.use_viewdirs:
        plus_z = torch.tensor([[0.0, 0.0, 1.0]], device=dev)
        d_enc = positional_encoding(plus_z, num_freqs=cfg.num_freqs_dir).expand(pts.shape[0], -1)
    _, sigma = mlp(x_enc, d_enc, cfg)
    return sigma.reshape(g, g, g)


def ray_segment_alphas(grid: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       near: float, far: float, *, n_segments: int = DEFAULT_N_SEGMENTS,
                       aabb=None):
    """-> (alphas (R, n_segments), edges (n_segments + 1,)): each ray's
    [near, far] cut into uniform segments, alpha = 1 - exp(-sigma seg_len)
    with sigma read from the nearest cell at the segment's midpoint, 0
    outside the box (tinynerf_tpu/ops/occupancy.py:119-149)."""
    box = _box(aabb, rays_o.device)
    g = grid.shape[0]
    lo, hi = box[0], box[1]
    edges = linspace(near, far, n_segments + 1, device=rays_o.device)
    mids = 0.5 * (edges[1:] + edges[:-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[None, :, None]
    u = (pts - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
    idx = torch.clamp((u * g).to(torch.int32), 0, g - 1).long()
    sigma = grid[idx[..., 0], idx[..., 1], idx[..., 2]]
    sigma = torch.where(inside, sigma, torch.zeros_like(sigma))
    seg_len = (far - near) / n_segments * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return 1.0 - torch.exp(-sigma * seg_len), edges


def occupancy_samples(grid: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
                      near: float, far: float, n_samples: int, *,
                      n_segments: int = DEFAULT_N_SEGMENTS, floor: float = DEFAULT_FLOOR,
                      aabb=None, randomized: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(R, n_samples) sorted depths importance-sampled from the grid: the
    segment weights alpha + floor, inverse-CDF sampled by sample_pdf
    (tinynerf_tpu/ops/occupancy.py:152-177). floor is the exploration
    term (inf: stratified-uniform; 0: never revisit space the grid
    believes empty)."""
    alphas, edges = ray_segment_alphas(grid, rays_o, rays_d, near, far, n_segments=n_segments,
                                       aabb=aabb)
    bins = edges.expand(rays_o.shape[0], n_segments + 1)
    return sample_pdf(bins, alphas + floor, n_samples, randomized=randomized, generator=generator)


def _proposal(grid, ro, rd, generator, s, noise_scale, n_segments, floor, aabb):
    """A step's grid-proposed depths (R, S) and sigma-noise (R, S) or
    None, drawn from `generator` in that order."""
    z = occupancy_samples(grid, ro, rd, s.near, s.far, s.n_samples, n_segments=n_segments,
                          floor=floor, aabb=aabb, randomized=True, generator=generator)
    noise = None
    if s.sigma_noise_std > 0.0:
        noise = (noise_scale * s.sigma_noise_std * torch.randn(
            z.shape, generator=generator, dtype=torch.float32, device=generator.device)
        ).to(ro.device)
    return z, noise


def make_occupancy_loss(cfg, *, n_segments: int = DEFAULT_N_SEGMENTS,
                        floor: float = DEFAULT_FLOOR, aabb=None):
    """The eager single-MLP loss on grid-proposed depths
    (tinynerf_tpu/ops/occupancy.py:180-223): (model, grid, ro, rd, target,
    generator, s, noise_scale=1.0) -> (mse, metrics); model.fine is the
    MLP, the grid an argument without gradient."""
    from tinynerf_tpu_torch.models.nerf import run_mlp, view_encoding
    from tinynerf_tpu_torch.ops.volume import volume_render
    from tinynerf_tpu_torch.utils.metrics import mse2psnr

    def loss(model, grid, ro, rd, target, generator, s, noise_scale=1.0):
        z, noise = _proposal(grid, ro, rd, generator, s, noise_scale, n_segments, floor, aabb)
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        rgb, sigma = run_mlp(model.fine, pts, view_encoding(rd, cfg), cfg,
                             sigma_noise=None if noise is None else noise.reshape(-1, 1))
        comp, _, _, _ = volume_render(rgb, sigma, z, rd, white_bkgd=s.white_bkgd)
        mse = torch.mean((comp - target.float()) ** 2)
        return mse, {"loss": mse.detach(), "psnr": mse2psnr(mse.detach())}

    return loss


def make_occupancy_fused_grad_fn(cfg, *, n_segments: int = DEFAULT_N_SEGMENTS,
                                 floor: float = DEFAULT_FLOOR, aabb=None,
                                 sample_block: Optional[int] = None):
    """The fused twin of make_occupancy_loss
    (tinynerf_tpu/ops/occupancy.py:226-265): the depths proposed from the
    grid in torch, the MLP's forward and backward through K6 on them ->
    (model, grid, ro, rd, target, generator, s, noise_scale=1.0) ->
    (loss, metrics), writing each parameter's .grad. On CPU tensors K6's
    plain version runs."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        pick_sample_block,
    )
    from tinynerf_tpu_torch.utils.metrics import mse2psnr

    def grad_fn(model, grid, ro, rd, target, generator, s, noise_scale=1.0):
        z, noise = _proposal(grid, ro, rd, generator, s, noise_scale, n_segments, floor, aabb)
        loss, grads = fused_nerf_pass_grads_streamed(
            model.fine, ro, rd, target, z, sigma_noise=noise, white_bkgd=s.white_bkgd, cfg=cfg,
            sample_block=sample_block or pick_sample_block(z.shape[1]))
        for p, g in zip(model.fine.parameters(), grads):
            p.grad = g
        return loss, {"loss": loss, "psnr": mse2psnr(loss)}

    return grad_fn


def make_occupancy_train_block(s, block_size: int, cfg, *,
                               resolution: int = DEFAULT_RESOLUTION,
                               n_segments: int = DEFAULT_N_SEGMENTS,
                               floor: float = DEFAULT_FLOOR, aabb=None, fused: bool = False,
                               mesh=None, extra_grad_fn=None):
    """`block_size` steps of the occupancy proposal with the signature of
    training.make_train_block: (model, optimizer, seed, step0, rays_o_all,
    rays_d_all, pixels) -> metrics (device tensors with a leading block
    axis); model is a NeRF(parts=("fine",)), updated in place with the
    optimizer (tinynerf_tpu/ops/occupancy.py:267-398).

    Per block the grid is rebuilt once from the current parameters, its
    cells jittered by grid_generator(seed, step0); s.n_samples is the
    proposal's whole budget. fused takes make_occupancy_fused_grad_fn
    (K6), else autograd of make_occupancy_loss. mesh (parallel/mesh.Mesh)
    spreads the rays over its data axis, each rank drawing n_rand / n_data
    from rank_generator, and mean-reduces gradients and metrics over it;
    the grid needs no collective (every rank rebuilds it from the same
    parameters). extra_grad_fn (model, generator) -> grads (the sparsity
    prior) is added after the reduction (training.add_extra_grads)."""
    from tinynerf_tpu_torch.training import (
        add_extra_grads,
        draw_ray_batch,
        noise_scale,
        step_generator,
    )

    local = s
    if mesh is not None:
        from tinynerf_tpu_torch.parallel.mesh import mesh_axes

        n_data, n_sample = mesh_axes(mesh)
        if n_sample > 1:
            raise ValueError("the occupancy proposal supports data-parallel meshes only (got "
                             f"sample axis {n_sample})")
        if s.n_rand % n_data:
            raise ValueError(f"n_rand={s.n_rand} not divisible by data axis {n_data}")
        local = dataclasses.replace(s, n_rand=s.n_rand // n_data)
    kw = dict(n_segments=n_segments, floor=floor, aabb=aabb)
    fn = make_occupancy_fused_grad_fn(cfg, **kw) if fused else make_occupancy_loss(cfg, **kw)

    def step_body(model, optimizer, seed, step, grid, rays_o_all, rays_d_all, pixels):
        dev = rays_o_all.device
        if mesh is None:
            gen = step_generator(seed, step, dev)
        else:
            from tinynerf_tpu_torch.parallel.train import rank_generator

            gen = rank_generator(seed, step, mesh.data_idx, dev)
        ro, rd, target = draw_ray_batch(local, gen, step, rays_o_all, rays_d_all, pixels)
        scale = noise_scale(s, step)
        optimizer.zero_grad(set_to_none=True)
        if fused:
            _, metrics = fn(model, grid, ro, rd, target, gen, s, noise_scale=scale)
        else:
            with torch.enable_grad():
                value, metrics = fn(model, grid, ro, rd, target, gen, s, noise_scale=scale)
                value.backward()
        if mesh is not None:
            from tinynerf_tpu_torch.parallel.mesh import DATA_AXIS
            from tinynerf_tpu_torch.parallel.train import mean_grads

            mean_grads(model, mesh, (DATA_AXIS,))
        if extra_grad_fn is not None:
            add_extra_grads(model, seed, step, dev, extra_grad_fn)
        optimizer.step()
        return metrics

    def block(model, optimizer, seed, step0, rays_o_all, rays_d_all, pixels):
        grid = density_grid(model.fine, cfg, resolution=resolution, aabb=aabb,
                            generator=grid_generator(seed, step0, rays_o_all.device))
        ms = [step_body(model, optimizer, seed, step0 + i, grid, rays_o_all, rays_d_all, pixels)
              for i in range(block_size)]
        out = {k: torch.stack([m[k].float() for m in ms]) for k in ms[0]}
        if mesh is not None:
            from tinynerf_tpu_torch.parallel.mesh import DATA_AXIS
            from tinynerf_tpu_torch.parallel.train import mean_over

            keys = list(out)
            stacked = mean_over(torch.stack([out[k] for k in keys]), mesh, (DATA_AXIS,))
            out = dict(zip(keys, stacked))
        return out

    return block
