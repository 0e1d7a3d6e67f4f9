"""Block-partials NeRF-MLP kernel pair (K7): the fused MLP pass under a
sample-sharded mesh (parallel/train.py).

make_fused_block_partials_fn replaces the Pallas TPU kernels of
tinynerf_tpu/kernels/fused_partials.py:381 (the custom_vjp at :476-559
over _partials_fwd_kernel and _partials_bwd_kernel). It returns
f(mlp, rays_o, rays_d, z_vals, deltas, sigma_noise) -> (partials,
local_weights | None), the drop-in for ops/volume.composite_block_partials
over an eager MLP: `partials` is the same {T, C, D, A} dict per ray over
this shard's depths and `local_weights` (emit_weights) the same alpha x
within-shard transmittance. f is a torch.autograd.Function:

- forward: the K7 forward kernel walks the shard's sample blocks
  carrying (T_run, C, A, D) and writes the partials, each block's entry
  transmittance (the residual) and optionally the local weights;
- backward: the K7 backward kernel takes the cotangents of the partials
  (g_C, g_A, g_T, g_D) and of the local weights and returns the MLP's
  parameter gradients. Rays, depths, deltas and noise get none: they are
  data or resampling products that carry no gradient in every caller, as
  in the JAX package (:554-557).

Both kernels are C entry points of csrc/fused_partials.cu, the walk of K6
(csrc/nerf_train_walk.cuh). On the route of
fused_nerf_train.uses_tensor_cores (by configuration) both run their MLP
products on the tensor cores in bf16 at the widths they take, from the
fragments of pack_mma_weights packed once by the forward and kept for
the backward (.mma_launches counts those launches); f32, and bf16 at
other widths, run on the CUDA cores; the shape route is K4's and K6's
(nerf_shape: the one-round or the general walk, counted by
.general_launches and .spill_launches). The wrapper pads the rays to whole
tiles as K4/K6's launch_pass does, so any ray count is taken; the sample
block must divide the shard's sample count, at any width.

block_partials_plain (the forward in torch ops, composited in blocks with
the entry transmittance carried) and block_partials_grads_plain
(torch.autograd.grad of it with the same cotangents) are the plain
versions: the CPU path of the wrapper, the tests' subject and the
reference the kernels are checked against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import torch

from tinynerf_tpu_torch.kernels.fused_nerf import (
    NerfShape,
    check_inputs,
    composite_one_m,
    launch_shape,
    pack_nerf_weights,
    pad_rays,
    padded_widths,
    spill_buffer,
    unpad_grads,
)
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    count_launch,
    pack_backward_weights,
    pack_mma_weights,
    scatter_index,
    uses_tensor_cores,
)
from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP, run_mlp, view_encoding
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

# The JAX signature's defaults (tinynerf_tpu/kernels/fused_partials.py:64-65).
DEFAULT_TILE_R = 128
DEFAULT_SAMPLE_BLOCK = 128


def _check_block(S: int, sample_block: int) -> int:
    sample_block = min(sample_block, S)
    if sample_block < 1 or S % sample_block:
        raise ValueError(
            f"shard sample count S={S} must be a multiple of sample_block={sample_block}"
        )
    return sample_block


def block_partials_plain(mlp: NeRFMLP, rays_o, rays_d, z_vals, deltas, sigma_noise=None, *,
                         cfg: Optional[NeRFConfig] = None, sample_block: int = DEFAULT_SAMPLE_BLOCK,
                         emit_weights: bool = False):
    """K7's forward in torch ops -> ({"T", "C", "D", "A"}, local weights
    (R, S) or None). The shard's blocks of `sample_block` samples are
    composited in order with the entry transmittance carried, as the
    kernel walks them; the result keeps its autograd graph when grad is
    enabled. A float64 copy of the MLP gives the same function with
    float64 sums."""
    cfg = cfg or mlp.cfg
    R, S = z_vals.shape
    sb = _check_block(S, sample_block)
    d_enc_ray = view_encoding(rays_d, cfg)
    T_run = torch.ones(R, dtype=z_vals.dtype, device=rays_o.device)
    C = A = D = 0.0
    ws = []
    for s0 in range(0, S, sb):
        zb = z_vals[:, s0:s0 + sb]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * zb[..., None]
        noise = None
        if sigma_noise is not None:
            noise = sigma_noise[:, s0:s0 + sb].reshape(-1, 1)
        rgb, sigma = run_mlp(mlp, pts, d_enc_ray, cfg, sigma_noise=noise)
        c, a, w, blk = composite_one_m(rgb, sigma, deltas[:, s0:s0 + sb], t_in=T_run)
        C, A, D, T_run = C + c, A + a, D + torch.sum(w * zb, dim=-1), T_run * blk
        ws.append(w)
    partials = {"T": T_run, "C": C, "D": D, "A": A}
    return partials, (torch.cat(ws, dim=1) if emit_weights else None)


def block_partials_grads_plain(mlp: NeRFMLP, rays_o, rays_d, z_vals, deltas, sigma_noise,
                               g_partials: Dict[str, torch.Tensor],
                               g_w: Optional[torch.Tensor] = None, *,
                               cfg: Optional[NeRFConfig] = None,
                               sample_block: int = DEFAULT_SAMPLE_BLOCK) -> List[torch.Tensor]:
    """K7's backward in torch ops: torch.autograd.grad of
    block_partials_plain with the cotangents g_partials ({"T", "C", "D",
    "A"}) and g_w (R, S) as grad_outputs -> gradients aligned to
    mlp.parameters()."""
    params = list(mlp.parameters())
    with torch.enable_grad():
        partials, w = block_partials_plain(mlp, rays_o, rays_d, z_vals, deltas, sigma_noise,
                                           cfg=cfg, sample_block=sample_block,
                                           emit_weights=g_w is not None)
        outs = [partials[k] for k in ("C", "A", "T", "D")]
        cots = [g_partials[k] for k in ("C", "A", "T", "D")]
        if g_w is not None:
            outs.append(w)
            cots.append(g_w)
        grads = torch.autograd.grad(outs, params, grad_outputs=[g.to(o.dtype) for g, o in
                                                                zip(cots, outs)])
    return list(grads)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/fused_partials.cu, typed for
    ctypes: every pointer and the stream as c_void_p."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("fused_partials")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.tinynerf_partials_fwd.argtypes = [p] * 10 + [i] * 14 + [p, i, p]
    lib.tinynerf_partials_fwd.restype = i
    lib.tinynerf_partials_bwd.argtypes = [p] * 15 + [i] * 15 + [p, i, p]
    lib.tinynerf_partials_bwd.restype = i
    lib.tinynerf_partials_workspace_floats.argtypes = [i] * 7
    lib.tinynerf_partials_workspace_floats.restype = ctypes.c_longlong
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _check_launch(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, z, deltas, sigma_noise,
                  sb: int) -> NerfShape:
    """Validate what K7 takes; returns its shape (nerf_shape) for blocks
    of sb samples."""
    check_inputs(mlp, cfg, rays_o, rays_d, z)
    for name, x in (("deltas", deltas), ("sigma_noise", sigma_noise)):
        if x is not None and (x.device != rays_o.device or x.dtype != torch.float32
                              or x.shape != z.shape):
            raise ValueError(f"{name} must be float32 {tuple(z.shape)} on {rays_o.device}")
    return launch_shape(cfg, z.shape[1], sb, walk=True, route=None)


def _as_shape(cfg: NeRFConfig, S: int, sb: int, tile) -> NerfShape:
    """A launch's shape: a NerfShape as given, or rays a tile (an int),
    which must be the configured shape's (nerf_shape)."""
    if isinstance(tile, NerfShape):
        return tile
    shape = launch_shape(cfg, S, sb, walk=True, route=None)
    if shape.tile_rays != tile:
        raise ValueError(f"{tile} rays a tile: the configured shape takes {shape.tile_rays}")
    return shape


def _geom(cfg: NeRFConfig):
    return (cfg.num_freqs, cfg.num_freqs_dir, int(cfg.use_viewdirs), cfg.hidden, cfg.depth,
            cfg.skip_at, cfg.rgb_hidden, int(cfg.compute_dtype == torch.bfloat16))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _n_blocks(n_tiles: int, dev) -> int:
    return min(n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)


@spanned
def fused_block_partials_fwd(mlp: NeRFMLP, cfg: NeRFConfig, o, d, z, delta, noise, sb: int,
                             tile, emit_weights: bool):
    """Launch the K7 forward on padded, contiguous inputs (R a multiple of
    the tile's rays) in `tile`, its NerfShape or its rays a tile (the
    configured shape's) -> (out (R, 6): C(3), A, T, D; tin (R, S / sb);
    weights (R, S) or None; the packed forward weights; the tensor-core
    fragments in bf16, else None)."""
    R, S = z.shape
    dev = o.device
    shape = _as_shape(cfg, S, sb, tile)
    tile = shape.tile_rays
    mma = uses_tensor_cores(cfg)
    with pack_span("fused_block_partials_fwd.pack", mlp):
        w_fwd = pack_nerf_weights(mlp, cfg)
        w_mma = pack_mma_weights(mlp, cfg) if mma else None
    out = torch.empty(R, 6, dtype=torch.float32, device=dev)
    tin = torch.empty(R, S // sb, dtype=torch.float32, device=dev)
    w_out = torch.empty(R, S, dtype=torch.float32, device=dev) if emit_weights else None
    n_blocks = _n_blocks(R // tile, dev)
    spill = spill_buffer(cfg, shape, n_blocks, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("fused_block_partials_fwd.launch"):
        err = _lib().tinynerf_partials_fwd(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), delta.data_ptr(), _ptr(noise),
            w_fwd.data_ptr(), _ptr(w_mma), out.data_ptr(), tin.data_ptr(), _ptr(w_out), R, tile,
            S, sb, *_geom(cfg), n_blocks, int(shape.general), _ptr(spill), dev.index, stream,
        )
    _raise_on(err, "fused_partials forward kernel")
    count_launch(fused_block_partials_fwd, cfg, shape)
    return out, tin, w_out, w_fwd, w_mma


fused_block_partials_fwd.launches = 0  # kernel launches since the last reset
# ... of which took the tensor-core walk (bf16 at the tensor-core widths)
fused_block_partials_fwd.mma_launches = 0
# ... of which ran the general walk (nerf_shape), and of those held X in device memory
fused_block_partials_fwd.general_launches = 0
fused_block_partials_fwd.spill_launches = 0


@spanned
def fused_block_partials_bwd(mlp: NeRFMLP, cfg: NeRFConfig, o, d, z, delta, noise, tin, g_ray,
                             g_w, w_fwd, w_mma, sb: int, tile) -> List[torch.Tensor]:
    """Launch the K7 backward on the forward's padded inputs, its tin and
    packed weights (w_mma: its tensor-core fragments on that route, else None),
    and the padded cotangents g_ray (R, 6) and g_w (R, S) or None, in the
    forward's shape (`tile` as fused_block_partials_fwd's) -> gradients
    aligned to mlp.parameters()."""
    R, S = z.shape
    dev = o.device
    shape = _as_shape(cfg, S, sb, tile)
    tile = shape.tile_rays
    mma = uses_tensor_cores(cfg)
    w_bwd = None
    if not mma:  # the tensor cores read the forward's fragments
        with pack_span("fused_block_partials_bwd.pack", mlp):
            w_bwd = pack_backward_weights(mlp, cfg)
    n_grad = w_fwd.numel()
    n_blocks = _n_blocks(R // tile, dev)
    lib = _lib()
    ws_floats = lib.tinynerf_partials_workspace_floats(tile, sb, cfg.num_freqs, cfg.hidden,
                                                       cfg.depth, cfg.rgb_hidden,
                                                       int(shape.general))
    ws = torch.empty(n_blocks, ws_floats, dtype=torch.float32, device=dev)
    spill = spill_buffer(cfg, shape, n_blocks, dev)
    partials = torch.empty(n_blocks, n_grad + 1, dtype=torch.float32, device=dev)
    params = list(mlp.parameters())
    out = torch.empty(sum(p.numel() for p in params) + 1, dtype=torch.float32, device=dev)
    dst = scatter_index(tuple(n for n, _ in mlp.named_parameters()), cfg, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("fused_block_partials_bwd.launch"):
        err = lib.tinynerf_partials_bwd(
            o.data_ptr(), d.data_ptr(), z.data_ptr(), delta.data_ptr(), _ptr(noise),
            tin.data_ptr(), g_ray.data_ptr(), _ptr(g_w), w_fwd.data_ptr(), _ptr(w_bwd),
            _ptr(w_mma), ws.data_ptr(), partials.data_ptr(), dst.data_ptr(), out.data_ptr(), R,
            tile, S, sb, *_geom(cfg), n_blocks, n_grad, int(shape.general), _ptr(spill),
            dev.index, stream,
        )
    _raise_on(err, "fused_partials backward kernel")
    count_launch(fused_block_partials_bwd, cfg, shape)
    grads, off = [], 0
    for p in params:
        grads.append(out[off:off + p.numel()].view(p.shape))
        off += p.numel()
    return grads


fused_block_partials_bwd.launches = 0  # kernel launches since the last reset
# ... of which took the tensor-core walk (bf16 at the tensor-core widths)
fused_block_partials_bwd.mma_launches = 0
# ... of which ran the general walk, and of those held X in device memory
fused_block_partials_bwd.general_launches = 0
fused_block_partials_bwd.spill_launches = 0


class _BlockPartials(torch.autograd.Function):
    """(spec, rays_o, rays_d, z, deltas, noise, *mlp parameters) ->
    (C (R, 3), A, T, D[, local weights (R, S)]). spec = (mlp, cfg,
    sample_block, emit_weights). CPU tensors take the plain versions,
    CUDA tensors the kernels."""

    @staticmethod
    def forward(ctx, spec, rays_o, rays_d, z, deltas, noise, *params):
        mlp, cfg, sb, emit_weights = spec
        ctx.spec = spec
        R = rays_o.shape[0]
        ctx.on_cpu = rays_o.device.type == "cpu" and rays_d.device.type == "cpu"
        if ctx.on_cpu:
            partials, w = block_partials_plain(mlp, rays_o, rays_d, z, deltas, noise, cfg=cfg,
                                               sample_block=sb, emit_weights=emit_weights)
            ctx.save_for_backward(rays_o, rays_d, z, deltas, noise)
            outs = (partials["C"], partials["A"], partials["T"], partials["D"])
            return outs + ((w,) if emit_weights else ())
        mlp, cfg = padded_widths(mlp, cfg)  # the kernels' widths (the same objects mostly)
        ctx.kernel_mlp = (mlp, cfg)
        shape = _check_launch(mlp, cfg, rays_o, rays_d, z, deltas, noise, sb)
        tile = shape.tile_rays
        pad = -R % tile
        S = z.shape[1]
        o, d = pad_rays(rays_o, rays_d, pad)
        # Padding rays: depths and deltas of one (finite), no noise.
        z_p = torch.cat([z, z.new_ones(pad, S)]).contiguous()
        delta_p = torch.cat([deltas, deltas.new_ones(pad, S)]).contiguous()
        noise_p = None if noise is None else torch.cat([noise, noise.new_zeros(pad, S)]).contiguous()
        out, tin, w_out, w_fwd, w_mma = fused_block_partials_fwd(mlp, cfg, o, d, z_p, delta_p,
                                                                 noise_p, sb, shape, emit_weights)
        ctx.shape, ctx.R = shape, R
        ctx.save_for_backward(o, d, z_p, delta_p, noise_p, tin, w_fwd, w_mma)
        outs = (out[:R, 0:3].contiguous(), out[:R, 3].contiguous(), out[:R, 4].contiguous(),
                out[:R, 5].contiguous())
        return outs + ((w_out[:R],) if emit_weights else ())

    @staticmethod
    def backward(ctx, g_c, g_a, g_t, g_d, *g_w):
        mlp, cfg, sb, emit_weights = ctx.spec
        g_w = g_w[0] if emit_weights else None
        if ctx.on_cpu:
            rays_o, rays_d, z, deltas, noise = ctx.saved_tensors
            grads = block_partials_grads_plain(
                mlp, rays_o, rays_d, z, deltas, noise, {"C": g_c, "A": g_a, "T": g_t, "D": g_d},
                g_w, cfg=cfg, sample_block=sb)
        else:
            o, d, z_p, delta_p, noise_p, tin, w_fwd, w_mma = ctx.saved_tensors
            mlp_k, cfg_k = ctx.kernel_mlp
            pad = o.shape[0] - ctx.R
            g_ray = torch.cat([g_c, g_a[:, None], g_t[:, None], g_d[:, None]], dim=1).float()
            g_ray = torch.cat([g_ray, g_ray.new_zeros(pad, 6)]).contiguous()
            g_w_p = None
            if g_w is not None:
                g_w_p = torch.cat([g_w.float(), g_w.new_zeros(pad, z_p.shape[1])]).contiguous()
            grads = unpad_grads(
                fused_block_partials_bwd(mlp_k, cfg_k, o, d, z_p, delta_p, noise_p, tin, g_ray,
                                         g_w_p, w_fwd, w_mma, sb, ctx.shape), cfg, cfg_k)
        return (None, None, None, None, None, None, *grads)


def make_fused_block_partials_fn(cfg: NeRFConfig = NeRFConfig(), *, emit_weights: bool = False,
                                 tile_r: int = DEFAULT_TILE_R,
                                 sample_block: int = DEFAULT_SAMPLE_BLOCK):
    """-> f(mlp, rays_o, rays_d, z_vals, deltas, sigma_noise) returning
    ({"T", "C", "D", "A"}, local weights (R, S) or None), differentiable
    with respect to the MLP's parameters through the K7 backward kernel.

    deltas must be the caller's global_deltas slice; sigma_noise (R, S)
    is the pre-ReLU density noise, or None. Raises when sample_block does
    not divide the shard's sample count. tile_r is the JAX signature's ray
    tile: the CUDA kernel picks its own shape (nerf_shape) and pads the
    rays to its tile, so any ray count works. CUDA tensors launch the
    kernels (or raise); CPU tensors take the plain versions."""
    del tile_r

    def f(mlp: NeRFMLP, rays_o, rays_d, z_vals, deltas, sigma_noise=None):
        sb = _check_block(z_vals.shape[1], sample_block)
        outs = _BlockPartials.apply((mlp, cfg, sb, emit_weights), rays_o, rays_d, z_vals, deltas,
                                    sigma_noise, *mlp.parameters())
        partials = {"T": outs[2], "C": outs[0], "D": outs[3], "A": outs[1]}
        return partials, (outs[4] if emit_weights else None)

    return f
