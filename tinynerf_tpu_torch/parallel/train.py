"""Sharded training: data-parallel ray batches and optional sample-axis
parallelism over a process mesh (parallel/mesh.py).

Port of tinynerf_tpu/parallel/train.py:48-402.
- The data axis: each rank draws its own n_rand / n_data rays, computes
  its local gradients, and the gradients are mean-reduced over the axis,
  so the global batch is n_rand.
- The sample axis (optional): the per-ray sample axis is block-sharded.
  Each rank runs the MLP on its block of samples only and summarizes it
  with the block composite (ops/volume.py: T, C, D, A per ray); the
  summaries are all-gathered and combined. Every sample peer computes the
  same loss, and all_gather's backward sums the peers' cotangents, so a
  rank's gradient is n_sample times its block's share; the mean over the
  axis gives the sum of the blocks' shares, as the JAX package's pmean.
  With fused_kernels=True each pass's encode -> MLP -> block composite is
  K7, the block-partials kernel pair (kernels/fused_partials.py).

Randomness: per step, each rank draws from a torch.Generator seeded by
(seed, step, data_idx) (rank_generator): the ray indices first, then
the stratified jitter, then (NeRF) sample_pdf's u. The sample index is
not in the seed, so sample peers draw the same rays, jitter and u, as
the JAX package's key does not involve it (:67-69). The sigma-noise of a
pass is drawn per shard, from a generator seeded by (seed, step,
data_idx, pass, sample_idx) (_block_sigma_noise, the JAX fold_in of the
sample index, :48-55).

An axis of one rank runs no collective, as the JAX package's `if
n_sample > 1` branches: a world of one runs K7 on the whole union with
no process group. Every rank ends a step with bit-identical parameters:
the gradients' means come from all_reduces whose results are the same
on every rank, and Adam applies the same update to them.

The training levers are training.py's: the batch draw (pool mode and
precrop included), the sigma-noise schedule (noise_scale, the same on
every rank) and the optimizer. extra_grad_fn (the sparsity prior) is
added after the mean-reduce, drawn from training.prior_generator, which
every rank seeds alike from (seed, step) (the JAX package's shared key,
:368-376), so the replicas stay bit-identical.

PyTorch runs eagerly: the block is a Python loop over its steps (the
JAX package's shard_map'd lax.scan).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from tinynerf_tpu_torch.models.nerf import run_mlp, view_encoding
from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.sampling import sample_pdf, stratified_samples
from tinynerf_tpu_torch.ops.volume import (
    combine_block_partials,
    composite_block_partials,
    global_deltas,
)
from tinynerf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SAMPLE_AXIS,
    Mesh,
    all_gather,
    all_reduce_sum,
    gather,
    make_mesh,
    mesh_axes,
)
from tinynerf_tpu_torch.training import (
    TrainSettings,
    add_extra_grads,
    draw_ray_batch,
    mix_seed,
    noise_scale,
)
from tinynerf_tpu_torch.utils.metrics import mse2psnr
from tinynerf_tpu_torch.utils.profiling import span

def rank_generator(seed: int, step: int, data_idx: int, device) -> torch.Generator:
    """The generator of one step on one data index (see the module
    docstring)."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, step, data_idx))


def _block_sigma_noise(noise_key, pass_idx: int, sample_idx: int, shape, noise_std: float,
                       device, scale=1.0) -> torch.Tensor:
    """This shard's pre-ReLU density noise, N(0, noise_std) * scale:
    deterministic given (noise_key = (seed, step, data_idx), the pass, the
    sample index), so every sample peer's gathered composite is the
    same."""
    g = torch.Generator(device=device).manual_seed(mix_seed(*noise_key, pass_idx, sample_idx))
    return scale * noise_std * torch.randn(shape, generator=g, dtype=torch.float32, device=device)


def _combine(partials: Dict[str, torch.Tensor], mesh: Mesh, white_bkgd: bool):
    """Combine this shard's partials with its sample peers' -> (comp,
    the gathered {T, C, D, A} stacked on a leading block axis). One
    all_gather of the (R, 6) packed partials; none on one shard."""
    if mesh.n_sample == 1:
        stacked = {k: v[None] for k, v in partials.items()}
    else:
        packed = torch.cat([partials["C"], torch.stack(
            [partials["A"], partials["T"], partials["D"]], dim=-1)], dim=-1)
        g = all_gather(packed, mesh, SAMPLE_AXIS)  # (B, R, 6)
        stacked = {"C": g[..., 0:3], "A": g[..., 3], "T": g[..., 4], "D": g[..., 5]}
    comp, _, _ = combine_block_partials(stacked, white_bkgd=white_bkgd)
    return comp, stacked


def sharded_pass(mlp, rays_o, rays_d, z_vals, mesh: Mesh, cfg, *, need_weights: bool = False,
                 white_bkgd: bool = True, fused_kernels: bool = False,
                 sigma_noise: Optional[torch.Tensor] = None):
    """One NeRF-MLP pass over the depths z_vals (R, S), the same on every
    sample peer, with the sample axis sharded over the mesh -> (comp
    (R, 3), the global per-sample weights (R, S) without gradient, or
    None). sigma_noise (R, S / n_sample) is this shard's pre-ReLU noise.
    fused_kernels runs the shard through K7 (in blocks of
    pick_sample_block(S / n_sample)), else through the eager MLP and
    composite_block_partials."""
    R, S = z_vals.shape
    sb = S // mesh.n_sample
    deltas = global_deltas(z_vals, rays_d)
    lo = mesh.sample_idx * sb
    z_blk = z_vals[:, lo:lo + sb].contiguous()
    d_blk = deltas[:, lo:lo + sb].contiguous()
    if fused_kernels:
        from tinynerf_tpu_torch.kernels.fused_nerf_stream import pick_sample_block
        from tinynerf_tpu_torch.kernels.fused_partials import make_fused_block_partials_fn

        fn = make_fused_block_partials_fn(cfg, emit_weights=need_weights,
                                          sample_block=pick_sample_block(sb))
        partials, w_local = fn(mlp, rays_o, rays_d, z_blk, d_blk, sigma_noise)
    else:
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z_blk[..., None]
        noise = None if sigma_noise is None else sigma_noise.reshape(-1, 1)
        rgb, sigma = run_mlp(mlp, pts, view_encoding(rays_d, cfg), cfg, sigma_noise=noise)
        partials, w_local = composite_block_partials(rgb, sigma, z_blk, d_blk, return_weights=True)
    comp, stacked = _combine(partials, mesh, white_bkgd)
    if not need_weights:
        return comp, None
    with torch.no_grad():
        if mesh.n_sample == 1:
            return comp, w_local.detach()
        # The local weights scaled by this block's entry transmittance (the
        # exclusive product of the earlier blocks' T), gathered.
        cum = torch.cumprod(stacked["T"], dim=0)
        lead = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], dim=0)
        w_blocks = gather(w_local * lead[mesh.sample_idx][:, None], mesh, SAMPLE_AXIS)
        return comp, w_blocks.permute(1, 0, 2).reshape(R, S)


def _sharded_loss(model, ro, rd, target, generator, s: TrainSettings, mesh: Mesh, noise_key,
                  noise_scale=1.0):
    """TinyNeRF loss over this rank's rays, the MLP restricted to its
    sample block (eager only, as in the JAX package)."""
    R = ro.shape[0]
    sb = s.n_samples // mesh.n_sample
    # z for ALL samples, the same across the sample peers.
    z_vals, _ = stratified_samples(s.near, s.far, s.n_samples, ro, rd, randomized=True,
                                   generator=generator)
    deltas = global_deltas(z_vals, rd)
    lo = mesh.sample_idx * sb
    z_blk, d_blk = z_vals[:, lo:lo + sb], deltas[:, lo:lo + sb]
    pts = ro[:, None, :] + rd[:, None, :] * z_blk[..., None]
    xenc = positional_encoding(pts.reshape(-1, 3), num_freqs=s.num_freqs)
    noise = None
    if s.sigma_noise_std > 0.0:
        noise = _block_sigma_noise(noise_key, 0, mesh.sample_idx, (R * sb, 1), s.sigma_noise_std,
                                   ro.device, noise_scale)
    rgb, sigma = model(xenc, s.model_cfg, sigma_noise=noise)
    partials = composite_block_partials(rgb.reshape(R, sb, 3), sigma.reshape(R, sb), z_blk, d_blk)
    comp, _ = _combine(partials, mesh, s.white_bkgd)
    loss = torch.mean((comp - target.float()) ** 2)
    return loss, {"loss": loss.detach(), "psnr": mse2psnr(loss.detach())}


def _sharded_nerf_loss(model, ro, rd, target, generator, s: TrainSettings, mesh: Mesh, cfg,
                       n_fine: int, noise_key, noise_scale=1.0, fused_kernels: bool = False):
    """The hierarchical (coarse + fine) loss with each pass's sample axis
    sharded over the mesh: mse(coarse) + mse(fine), the resampling weights
    without gradient, the PSNR of the fine composite
    (models/nerf.make_hierarchical_loss's semantics)."""
    R = ro.shape[0]

    def noise(pass_idx, S):
        if s.sigma_noise_std <= 0.0:
            return None
        return _block_sigma_noise(noise_key, pass_idx, mesh.sample_idx, (R, S // mesh.n_sample),
                                  s.sigma_noise_std, ro.device, noise_scale)

    kw = dict(white_bkgd=s.white_bkgd, fused_kernels=fused_kernels)
    z_c, _ = stratified_samples(s.near, s.far, s.n_samples, ro, rd, randomized=True,
                                generator=generator)
    comp_c, weights = sharded_pass(model.coarse, ro, rd, z_c, mesh, cfg, need_weights=True,
                                   sigma_noise=noise(0, s.n_samples), **kw)
    z_mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = sample_pdf(z_mids, weights[:, 1:-1], n_fine, randomized=True, generator=generator)
    z_union = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    comp_f, _ = sharded_pass(model.fine, ro, rd, z_union, mesh, cfg,
                             sigma_noise=noise(1, s.n_samples + n_fine), **kw)
    t = target.float()
    mse_c = torch.mean((comp_c - t) ** 2)
    mse_f = torch.mean((comp_f - t) ** 2)
    mse_f_d = mse_f.detach()
    return mse_c + mse_f, {"loss": mse_f_d, "psnr": mse2psnr(mse_f_d),
                           "loss_coarse": mse_c.detach()}


def mean_over(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """x averaged over the ranks of each axis in turn (the JAX pmean)."""
    for axis in axes:
        n = mesh.axis_size(axis)
        if n > 1:
            x = all_reduce_sum(x, mesh, axis) / n
    return x


def mean_grads(model, mesh: Mesh, axes) -> None:
    """Each parameter's .grad (zero where there is none) averaged over the
    ranks of each axis in turn, in one collective over the flat gradient."""
    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    flat = mean_over(flat, mesh, axes)
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p)
        off += p.numel()


def make_sharded_train_block(
    s: TrainSettings,
    block_size: int,
    mesh: Optional[Mesh] = None,
    loss=None,
    grad_fn=None,
    nerf_cfg=None,
    n_fine: int = 64,
    fused_kernels: bool = False,
    extra_grad_fn=None,
):
    """The sharded block with the signature of training.make_train_block:
    (model, optimizer, seed, step0, rays_o_all, rays_d_all, pixels) ->
    metrics (device tensors with a leading block axis, averaged over
    every rank); updates model and optimizer in place.

    The loss is the TinyNeRF sharded loss, or with nerf_cfg the sharded
    hierarchical NeRF loss (fused_kernels: K7 for each pass); `loss` (any
    training.make_train_step loss) and grad_fn (a fused train kernel:
    K2, or K4/K6 through make_fused_nerf_grad_fn) are data-parallel only.
    After each step's backward the gradients are mean-reduced over the
    sample axis, then the data axis; extra_grad_fn (model, generator) ->
    grads (ops/regularizers.make_sparsity_grad_fn) is then added, the same
    on every rank."""
    mesh = mesh or make_mesh()
    n_data, n_sample = mesh_axes(mesh)
    if s.n_rand % n_data:
        raise ValueError(f"n_rand={s.n_rand} not divisible by data axis {n_data}")
    if s.n_samples % n_sample:
        raise ValueError(f"n_samples={s.n_samples} not divisible by sample axis {n_sample}")
    if nerf_cfg is not None:
        if loss is not None or grad_fn is not None:
            raise ValueError("nerf_cfg replaces loss/grad_fn")
        if (s.n_samples + n_fine) % n_sample:
            raise ValueError(
                f"fine union {s.n_samples}+{n_fine} not divisible by sample axis {n_sample}")
    elif fused_kernels:
        raise ValueError(
            "fused_kernels requires nerf_cfg (the block-partials kernels implement the NeRF MLP; "
            "the TinyNeRF sharded loss is eager only)")
    elif loss is not None and n_sample > 1:
        raise ValueError(
            "generic custom losses are data-parallel only (they are not sample-axis aware); pass "
            "nerf_cfg for the sharded hierarchical loss, or use sample_parallel=1")
    if grad_fn is not None and n_sample > 1:
        raise ValueError("grad_fn (fused train kernel) is data-parallel only")
    local = dataclasses.replace(s, n_rand=s.n_rand // n_data)

    def step_body(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels):
        with span("step"):
            with span("step.draw"):
                gen = rank_generator(seed, step, mesh.data_idx, rays_o_all.device)
                ro, rd, target = draw_ray_batch(local, gen, step, rays_o_all, rays_d_all, pixels)
            scale = noise_scale(s, step)
            optimizer.zero_grad(set_to_none=True)
            with span("step.grad"):
                if grad_fn is not None:
                    _, metrics = grad_fn(model, ro, rd, target, gen, noise_scale=scale)
                else:
                    key = (seed, step, mesh.data_idx)
                    with torch.enable_grad():  # whatever the caller's grad mode
                        if loss is not None:
                            value, metrics = loss(model, ro, rd, target, gen, s,
                                                  noise_scale=scale)
                        elif nerf_cfg is not None:
                            value, metrics = _sharded_nerf_loss(model, ro, rd, target, gen, s,
                                                                mesh, nerf_cfg, n_fine, key, scale,
                                                                fused_kernels=fused_kernels)
                        else:
                            value, metrics = _sharded_loss(model, ro, rd, target, gen, s, mesh,
                                                           key, scale)
                        value.backward()
                mean_grads(model, mesh, (SAMPLE_AXIS, DATA_AXIS))
                if extra_grad_fn is not None:
                    add_extra_grads(model, seed, step, rays_o_all.device, extra_grad_fn)
            with span("step.optimizer"):
                optimizer.step()
        return metrics

    def block(model, optimizer, seed, step0, rays_o_all, rays_d_all, pixels):
        ms = [step_body(model, optimizer, seed, step0 + i, rays_o_all, rays_d_all, pixels)
              for i in range(block_size)]
        keys = list(ms[0])
        stacked = torch.stack([torch.stack([m[k].float() for m in ms]) for k in keys])
        stacked = mean_over(stacked, mesh, (DATA_AXIS, SAMPLE_AXIS))
        return dict(zip(keys, stacked))

    return block
