"""Sample-block-streamed fused NeRF render pass (K5).

fused_nerf_render_rays_streamed replaces the Pallas TPU kernel
tinynerf_tpu/kernels/fused_nerf_stream.py:451 (body
_streamed_render_kernel): a forward render over a given sorted (R, S)
depth union that walks sample blocks of `sample_block` in order,
carrying (T_run, C, A) per ray: within a block the local exclusive
product of one_m, scaled by T_run, weights the samples; then
T_run <- T_run * (last local prefix * last one_m). Its state is
O(sample_block), not O(S), so the fine pass of a large union (the
`--n-fine 448` recipe: hidden 128, S = 512) runs in one launch.

The kernel is the second C entry point of csrc/fused_nerf.cu: it shares
K3's chunked MLP and encodings, and K3's routes (render_uses_tensor_cores:
bf16 at the tensor-core widths runs its products on the tensor cores
from pack_mma_forward's fragments, counted by .mma_launches; f32 and
other widths on the CUDA cores; nerf_shape's one-round or general kernel),
and adds the carried block walk. Any block that divides S is taken. The
deltas are precomputed here, as the JAX wrapper does (:488-496).

fused_nerf_render_rays_streamed_plain is the same block walk in torch
ops: the CPU path of the wrapper and the reference the kernel is
checked against on the card.

fused_nerf_pass_grads_streamed (K6) replaces the Pallas TPU kernel
tinynerf_tpu/kernels/fused_nerf_stream.py:548 (body _streamed_kernel):
the fused fwd+bwd of the fine pass over a given sorted union, streamed
over sample blocks. Its forward walk carries (T_run, C, A) and stashes
each block's entry T; its reverse walk rematerialises each block's
forward, rebuilds the transmittance from the stashed T and carries the
density gradient's recurrence across blocks, so its state is
O(sample_block). It is the
second C entry point of csrc/fused_nerf_train.cu (K4's kernel, segments
of sample_block samples); the deltas are precomputed here, as the JAX
wrapper does (:593-603). In bf16 (the training dtype) its MLP products
run on the tensor cores (mma.sync, csrc/mma_bf16.cuh) from the fragments
of pack_mma_weights, and .mma_launches counts those launches; in f32 they
run on the CUDA cores, as K4's do. fused_nerf_pass_grads_streamed_plain
is the same block walk through autograd.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from tinynerf_tpu_torch.kernels.fused_nerf import (
    _lib,
    check_launch,
    composite_one_m,
    deltas,
    general_blocks,
    pack_mma_forward,
    pack_nerf_weights,
    pad_rays,
    padded_widths,
    raise_on_error,
    render_uses_tensor_cores,
    spill_buffer,
    unpad_grads,
)
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    check_train_launch,
    count_launch,
    launch_pass,
    pass_grads_plain,
)
from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP, run_mlp, view_encoding
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

DEFAULT_SAMPLE_BLOCK = 64


def pick_sample_block(S: int, cap: int = DEFAULT_SAMPLE_BLOCK) -> int:
    """Largest divisor of S that is <= cap (the streamed kernels need
    sample_block | S; e.g. S=192 -> 64). Warns when S has no divisor in
    [8, cap]: the walk then takes S/b tiny blocks
    (tinynerf_tpu/kernels/fused_nerf_stream.py:71-92)."""
    for b in range(min(cap, S), 0, -1):
        if S % b == 0:
            if b < 8 and S > 8:
                warnings.warn(
                    f"pick_sample_block: S={S} has no divisor in [8, {cap}];"
                    f" streaming in blocks of {b} ({S // b} inner blocks) will"
                    " be slow — prefer a composite sample count (e.g. a"
                    " multiple of 64)"
                )
            return b
    return S


def _check_block(S: int, sample_block: int) -> int:
    sample_block = min(sample_block, S)
    if sample_block < 1 or S % sample_block:
        raise ValueError(f"S={S} must be a multiple of sample_block={sample_block}")
    return sample_block


def fused_nerf_render_rays_streamed_plain(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: int = DEFAULT_SAMPLE_BLOCK,
) -> torch.Tensor:
    """K5's block walk in torch ops -> comp_rgb (R, 3)."""
    cfg = cfg or mlp.cfg
    R, S = z_vals.shape
    sb = _check_block(S, sample_block)
    d_enc_ray = view_encoding(rays_d, cfg)
    delta = deltas(z_vals, rays_d)
    T_run = torch.ones(R, dtype=torch.float32, device=rays_o.device)
    C = torch.zeros(R, 3, dtype=torch.float32, device=rays_o.device)
    A = torch.zeros(R, dtype=torch.float32, device=rays_o.device)
    for s0 in range(0, S, sb):
        z = z_vals[:, s0:s0 + sb]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        rgb, sigma = run_mlp(mlp, pts, d_enc_ray, cfg)
        # trans = T_run * (block-local exclusive product of one_m).
        c, a, _, blk = composite_one_m(rgb, sigma, delta[:, s0:s0 + sb], t_in=T_run)
        C = C + c
        A = A + a
        T_run = T_run * blk
    return C + (1.0 - A[:, None]) if white_bkgd else C


@spanned
def fused_nerf_render_rays_streamed(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: int = DEFAULT_SAMPLE_BLOCK,
    route: Optional[str] = None,
) -> torch.Tensor:
    """Streamed forward render over a given sorted depth union ->
    comp_rgb (R, 3). Raises when S is not a multiple of sample_block.

    CUDA tensors launch the kernel (or raise), on the tensor cores or the
    CUDA cores by K3's route (render_uses_tensor_cores) and in K3's shape
    (nerf_shape; `route` forces one); CPU tensors take
    fused_nerf_render_rays_streamed_plain. `cfg` defaults to mlp.cfg."""
    cfg = cfg or mlp.cfg
    R, S = z_vals.shape
    sb = _check_block(S, sample_block)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_render_rays_streamed_plain(
            mlp, rays_o, rays_d, z_vals, white_bkgd=white_bkgd, cfg=cfg, sample_block=sb)
    given = mlp
    mlp, cfg = padded_widths(mlp, cfg)
    shape = check_launch(mlp, cfg, rays_o, rays_d, z_vals, sb, route)
    tile = shape.tile_rays

    pad = -R % tile
    dev = rays_o.device
    o, d = pad_rays(rays_o, rays_d, pad)
    z = torch.cat([z_vals, z_vals.new_ones(pad, S)]).contiguous()
    delta = deltas(z, d).contiguous()
    mma = render_uses_tensor_cores(cfg)
    with pack_span("fused_nerf_render_rays_streamed.pack", given):
        wts = pack_nerf_weights(mlp, cfg)
        w_mma = pack_mma_forward(mlp, cfg) if mma else None
    out = torch.empty(R + pad, 4, dtype=torch.float32, device=dev)
    n_blocks = general_blocks(shape, (R + pad) // tile, dev)
    spill = spill_buffer(cfg, shape, n_blocks, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("fused_nerf_render_rays_streamed.launch"):
        err = _lib().tinynerf_fused_nerf_streamed(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), delta.data_ptr(), wts.data_ptr(),
            None if w_mma is None else w_mma.data_ptr(), out.data_ptr(), R + pad, tile, S, sb,
            cfg.num_freqs, cfg.num_freqs_dir, int(cfg.use_viewdirs), cfg.hidden, cfg.depth,
            cfg.skip_at, cfg.rgb_hidden, int(cfg.compute_dtype == torch.bfloat16),
            int(shape.general), None if spill is None else spill.data_ptr(), n_blocks,
            dev.index, stream,
        )
    raise_on_error(err, "fused_nerf_streamed")
    fused_nerf_render_rays_streamed.launches += 1
    fused_nerf_render_rays_streamed.mma_launches += int(mma)
    fused_nerf_render_rays_streamed.general_launches += int(shape.general)
    fused_nerf_render_rays_streamed.spill_launches += int(shape.spill)
    comp = out[:R, :3]
    if white_bkgd:
        comp = comp + (1.0 - out[:R, 3:4])
    return comp


fused_nerf_render_rays_streamed.launches = 0  # kernel launches since the last reset
# ... of which took the tensor cores (K3's route)
fused_nerf_render_rays_streamed.mma_launches = 0
# ... of which ran the general kernel, and of those held X in device memory
fused_nerf_render_rays_streamed.general_launches = 0
fused_nerf_render_rays_streamed.spill_launches = 0


def fused_nerf_pass_grads_streamed_plain(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: int = DEFAULT_SAMPLE_BLOCK,
):
    """K6's block walk in torch ops, the entry transmittance carried from
    block to block through autograd -> (loss, grads aligned to
    mlp.parameters())."""
    cfg = cfg or mlp.cfg
    sb = _check_block(z_vals.shape[1], sample_block)
    loss, grads, _ = pass_grads_plain(mlp, rays_o, rays_d, target, z_vals, sigma_noise,
                                      white_bkgd, cfg, sb)
    return loss, grads


@spanned
def fused_nerf_pass_grads_streamed(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: int = DEFAULT_SAMPLE_BLOCK,
    route: Optional[str] = None,
):
    """One streamed fused fwd+bwd NeRF-MLP pass over a given sorted depth
    union z_vals (R, S) -> (loss, grads aligned to mlp.parameters()).
    sigma_noise (R, S) is the pre-ReLU density noise; both walks read the
    same buffer, so the rematerialised forward equals the first. Raises
    when S is not a multiple of sample_block.

    CUDA tensors launch the kernel (or raise), in the shape of nerf_shape
    (`route` forces one); CPU tensors take
    fused_nerf_pass_grads_streamed_plain. `cfg` defaults to mlp.cfg."""
    cfg = cfg or mlp.cfg
    R, S = z_vals.shape
    sb = _check_block(S, sample_block)
    kw = dict(sigma_noise=sigma_noise, white_bkgd=white_bkgd)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_pass_grads_streamed_plain(mlp, rays_o, rays_d, target, z_vals, cfg=cfg,
                                                    sample_block=sb, **kw)
    mlp_k, cfg_k = padded_widths(mlp, cfg)
    shape = check_train_launch(mlp_k, cfg_k, rays_o, rays_d, target, z_vals, sigma_noise, S, sb,
                               route)
    loss, grads = launch_pass(mlp_k, cfg_k, rays_o, rays_d, target, shape, S, streamed=True,
                              seg=sb, name="fused_nerf_pass_grads_streamed", given=mlp, z=z_vals,
                              **kw)
    count_launch(fused_nerf_pass_grads_streamed, cfg_k, shape)
    return loss, unpad_grads(grads, cfg, cfg_k)


fused_nerf_pass_grads_streamed.launches = 0  # kernel launches since the last reset
# ... of which took the tensor-core walk (bf16 at the tensor-core widths)
fused_nerf_pass_grads_streamed.mma_launches = 0
# ... of which trained a stack of scenes in one launch
fused_nerf_pass_grads_streamed.scene_launches = 0
# ... of which ran the general walk (nerf_shape), and of those held X in device memory
fused_nerf_pass_grads_streamed.general_launches = 0
fused_nerf_pass_grads_streamed.spill_launches = 0


def fused_nerf_pass_grads_streamed_scenes_plain(mlp: NeRFMLP, rays_o, rays_d, target, z_vals, *,
                                                sigma_noise=None, **kw):
    """fused_nerf_pass_grads_streamed_scenes in torch ops: K6's plain
    version on each scene in turn. The CPU path and the tests' subject."""
    from tinynerf_tpu_torch.models.stacked import per_scene

    return per_scene(fused_nerf_pass_grads_streamed_plain, mlp, (rays_o, rays_d, target, z_vals),
                     dict(sigma_noise=sigma_noise), **kw)


@spanned
def fused_nerf_pass_grads_streamed_scenes(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    z_vals: torch.Tensor,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: int = DEFAULT_SAMPLE_BLOCK,
):
    """One K6 launch for K stacked scenes over their sorted unions z_vals
    (K, R, S) -> (loss (K,), grads aligned to mlp.parameters(), each (K,
    *shape)). `mlp` stacks K scenes (multiscene.py), at any width (every
    scene padded alike); rays and target (K, R, 3), sigma_noise (K, R, S).
    Scene k's results are bit-identical to
    fused_nerf_pass_grads_streamed on its own weights and slabs. CUDA
    tensors launch the kernel (or raise; .launches and .scene_launches
    count one); CPU tensors take the plain version, scene by scene."""
    from tinynerf_tpu_torch.kernels.fused_nerf_train import check_scenes_launch

    cfg = cfg or mlp.cfg
    S = z_vals.shape[-1]
    sb = _check_block(S, sample_block)
    kw = dict(sigma_noise=sigma_noise, white_bkgd=white_bkgd)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_pass_grads_streamed_scenes_plain(mlp, rays_o, rays_d, target, z_vals,
                                                           cfg=cfg, sample_block=sb, **kw)
    mlp_k, cfg_k = padded_widths(mlp, cfg)
    shape = check_scenes_launch(mlp_k, cfg_k, rays_o, rays_d, target, z_vals, sigma_noise, S, sb)
    loss, grads = launch_pass(mlp_k, cfg_k, rays_o, rays_d, target, shape, S, streamed=True,
                              seg=sb, name="fused_nerf_pass_grads_streamed_scenes", given=mlp,
                              z=z_vals, **kw)
    count_launch(fused_nerf_pass_grads_streamed, cfg_k, shape, scenes=True)
    return loss, unpad_grads(grads, cfg, cfg_k)
