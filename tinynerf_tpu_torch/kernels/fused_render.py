"""Fused TinyNeRF render: rays -> depths -> points -> encoding -> MLP ->
composite, in one CUDA kernel (csrc/fused_render.cu).

Replaces the Pallas TPU kernel tinynerf_tpu/kernels/fused_render.py:211
(fused_render_rays; body _fused_kernel, in-kernel scans from
tinynerf_tpu/kernels/scans.py).

What bounds it on an H100: arithmetic. Each sample point costs about
66k multiply-adds in the MLP (63->128, 128->128, 191->128, 128->128 and
the 4-wide head) against 24 bytes of ray input per 64 points, so the
unfused composition is bound instead by the device-memory traffic of
its (points, 191) activations. The kernel keeps every point, encoding
and activation of a tile in shared memory and writes only (R, 4) back,
so it moves ~40 bytes per ray.

The route is chosen by configuration before the launch, never by a
failure (k1_uses_tensor_cores): bf16 with hidden a multiple of 32 and a
tile of at most 128 points (every S <= 128, the recipe's S=64 included)
runs the trunk as mma.sync products on the tensor cores
(csrc/mma_bf16.cuh) from the fragments of pack_tiny_weights, packed for
each launch by one gather; f32, and bf16 off that layout, run a
register-tiled 8x8 f32 product per thread on the CUDA cores, and the
shapes whose block would pass 512 threads or 227 KB (hidden 264, S=192
at hidden 256, S=512) the general CUDA-core kernel, in rounds of threads
and segments of samples (k1_shape). The render refuses no width and no
sample count: widths off multiples of 8 go in zero-padded
(padded_tiny_widths). .mma_launches counts the tensor-core launches and
.general_launches the general kernel's beside .launches.

Layout: the TPU kernel's feature-major, sample-major lanes, roll scans
and k-major encoding permutation are not carried over. A block holds
TR rays x S samples as point rows, computes the encoding directly in
the model's interleaved order, and one thread walks each ray's samples
front to back for the transmittance.

fused_render_rays_plain is the same computation in torch ops: the CPU
path of the wrapper and the reference the kernel is checked against on
the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from tinynerf_tpu_torch.kernels.fused_nerf import pack_mma_b, pad8, pad_linears, unpad_linears
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, layer_in_dims
from tinynerf_tpu_torch.ops.encoding import encoding_dim, positional_encoding
from tinynerf_tpu_torch.ops.rays import pad_rays
from tinynerf_tpu_torch.ops.volume import DELTA_INF, TRANS_EPS
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

# Points per block: TR = TILE_POINTS // S rays of S samples each.
TILE_POINTS = 128
MAX_SMEM_BYTES = 232448  # H100: 227 KB of dynamic shared memory per block
MAX_THREADS = 512  # csrc/fused_render.cu's kMaxThreads


def fused_render_rays_plain(
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
) -> torch.Tensor:
    """The kernel's semantics in torch ops -> composite RGB (R, 3).

    Analytic linspace depths z = near(1-t) + far t, t = s/(S-1), and
    uniform deltas (far-near)/(S-1) with the 1e10 terminal, times ||d||.
    """
    cfg = model_cfg or params.cfg
    S = n_samples
    dev = rays_o.device
    s = torch.arange(S, dtype=torch.float32, device=dev)
    t = s / (S - 1)
    z = near * (1.0 - t) + far * t  # (S,)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[None, :, None]  # (R, S, 3)
    enc = positional_encoding(pts.reshape(-1, 3), num_freqs=num_freqs)
    rgb, sigma = params(enc, cfg)
    R = rays_o.shape[0]
    rgb = rgb.reshape(R, S, 3)
    sigma = sigma.reshape(R, S)

    norm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)  # (R, 1)
    base = (far - near) / (S - 1)
    delta = torch.where(s == S - 1, DELTA_INF, base) * norm  # (R, S)
    one_m = torch.exp(-sigma * delta) + TRANS_EPS
    alpha = 1.0 - (one_m - TRANS_EPS)
    trans = torch.cumprod(one_m, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    comp = torch.sum(w[..., None] * rgb, dim=-2)
    if white_bkgd:
        comp = comp + (1.0 - torch.sum(w, dim=-1, keepdim=True))
    return comp


def _param_offsets(cfg: TinyNeRFConfig) -> dict:
    """Parameter name -> offset into the concatenation of TinyNeRF's
    parameters in their order (layers.{i}.weight/bias, sigma.0.*, rgb.0.*)."""
    shapes = {}
    for i, n_in in enumerate(layer_in_dims(cfg)):
        shapes[f"layers.{i}.weight"], shapes[f"layers.{i}.bias"] = cfg.hidden * n_in, cfg.hidden
    shapes.update({"sigma.0.weight": cfg.hidden, "sigma.0.bias": 1,
                   "rgb.0.weight": 3 * cfg.hidden, "rgb.0.bias": 3})
    out, off = {}, 0
    for name, n in shapes.items():
        out[name] = off
        off += n
    out["zero"] = off  # the one zero the packers append
    return out


def _operand_indices(cfg: TinyNeRFConfig, upstream: bool) -> List[tuple]:
    """The B operands (K, N) of K1's and K2's tensor-core products in
    packing order, as (name, matrix of indices into the parameters'
    concatenation): each trunk layer's forward W^T (in, hidden), then, with
    upstream, the W[:, :hidden] (hidden, hidden) of trunk layers
    1..depth-1 (the skip layer's encoding rows get no upstream gradient)."""
    h, off = cfg.hidden, _param_offsets(cfg)
    ws = [off[f"layers.{i}.weight"] + torch.arange(h * n_in).reshape(h, n_in)
          for i, n_in in enumerate(layer_in_dims(cfg))]
    out = [(f"layers.{i}.fwd", w.t()) for i, w in enumerate(ws)]
    return out + [(f"layers.{i}.up", w[:, :h]) for i, w in enumerate(ws) if i > 0 and upstream]


def tiny_mma_operands(params: TinyNeRF, cfg: TinyNeRFConfig) -> List[tuple]:
    """K1's and K2's B operands as (name, bf16 matrix), in packing order
    (_operand_indices): K1 reads the forward ones alone, at mma_fwd_off;
    K2 all of them."""
    flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()]).to(torch.bfloat16)
    return [(name, flat[idx]) for name, idx in _operand_indices(cfg, upstream=True)]


@functools.lru_cache(maxsize=None)
def _pack_index(cfg: TinyNeRFConfig, mma: bool, upstream: bool,
                device: torch.device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gathers of pack_tiny_weights over the parameters' concatenation
    `flat` (and its trailing zero): the f32 buffer's indices into [rounded
    flat, flat]; the fragments' indices into flat (_operand_indices packed
    by pack_mma_b, the K padding on the zero)."""
    h, off = cfg.hidden, _param_offsets(cfg)
    n = off["zero"] + 1
    head = torch.cat([off["rgb.0.weight"] + torch.arange(3 * h).reshape(3, h),
                      off["sigma.0.weight"] + torch.arange(h).reshape(1, h)]).t()
    parts = []
    for name, w in _operand_indices(cfg, upstream=False):
        i = name.split(".")[1]
        parts += [w.reshape(-1), n + off[f"layers.{i}.bias"] + torch.arange(h)]
    parts += [head.reshape(-1), n + off["rgb.0.bias"] + torch.arange(3),
              n + torch.tensor([off["sigma.0.bias"]])]
    fwd = torch.cat(parts).to(device)
    if not mma:
        return fwd, None
    # pack_mma_b pads K with zeros: shift by one so that 0 is the padding.
    frag = torch.cat([pack_mma_b(w + 1) for _, w in _operand_indices(cfg, upstream)])
    return fwd, torch.where(frag == 0, off["zero"], frag - 1).to(device)


@torch.no_grad()
def pack_tiny_weights(params: TinyNeRF, cfg: TinyNeRFConfig, *, mma: bool = False,
                      upstream: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's and K2's weight buffers from one concatenation of the
    parameters and one precomputed gather each -> (w_fwd, w_mma).

    w_fwd (f32): per trunk layer W (in, out) then b, then the head W
    (hidden, 4) with columns r, g, b, sigma, then its bias; weights
    rounded to compute_dtype, biases f32. w_mma (bf16, with mma): the
    tensor-core B fragments of tiny_mma_operands, each packed by
    pack_mma_b and concatenated, the forward operands alone or (upstream)
    followed by the upstream ones; else None. A model of stacked scenes
    (weights (K, out, in), multiscene.py) gives (K, n) buffers, one row a
    scene, from the same one concatenation and gathers."""
    ps = list(params.parameters())
    lead = ps[0].shape[:-2]  # layers.0.weight: (out, in), or (K, out, in)
    flat = torch.cat([p.reshape(*lead, -1) for p in ps] + [ps[0].new_zeros(*lead, 1)], dim=-1)
    fwd_idx, mma_idx = _pack_index(cfg, mma, upstream, flat.device)
    w_fwd = torch.cat([flat.to(cfg.compute_dtype).float(), flat], dim=-1)[..., fwd_idx]
    return w_fwd, None if mma_idx is None else flat.to(torch.bfloat16)[..., mma_idx]


def pack_weights(params: TinyNeRF, cfg: TinyNeRFConfig) -> torch.Tensor:
    """All weights as one f32 buffer in the kernels' order (pack_tiny_weights'
    w_fwd): per trunk layer W (in, out) then b, then the head W (hidden, 4)
    with columns r, g, b, sigma, then its bias. Weights are rounded to bf16
    when the compute dtype is bf16; biases stay f32."""
    return pack_tiny_weights(params, cfg)[0]


def _tiny_pad_index(cfg: TinyNeRFConfig, cfg_p: TinyNeRFConfig) -> dict:
    """Linear name -> (rows, columns) of its weight (out, in) inside the
    padded layer's: the hidden units keep their index, and the skip
    layer's encoding columns follow the padded hidden ones ([h | 0 | enc])."""
    h, hp = cfg.hidden, cfg_p.hidden
    out = {}
    for i, n_in in enumerate(layer_in_dims(cfg)):
        cols = torch.arange(n_in) if i == 0 or n_in == h else torch.cat(
            [torch.arange(h), hp + torch.arange(n_in - h)])
        out[f"layers.{i}"] = (torch.arange(h), cols)
    out["sigma.0"] = (torch.arange(1), torch.arange(h))
    out["rgb.0"] = (torch.arange(3), torch.arange(h))
    return out


def padded_tiny_widths(params: TinyNeRF, cfg: TinyNeRFConfig):
    """-> (params, cfg) at hidden rounded up to a multiple of 8, the widths
    the CUDA-core products of K1 and K2 take (8-column blocks, float4
    weight loads): the new units' weights and biases are zero, so each
    padded unit is ReLU(0) = 0 and feeds the next layer and the heads
    through zero weights; the function and the real units' gradients do
    not change. The same objects when hidden is a multiple of 8 already
    (every tensor-core width). Stacked scenes are padded alike."""
    cfg_p = dataclasses.replace(cfg, hidden=pad8(cfg.hidden))
    if cfg_p == cfg:
        return params, cfg
    return pad_linears(params, cfg_p, _tiny_pad_index(cfg, cfg_p)), cfg_p


def unpad_tiny_grads(grads: List[torch.Tensor], cfg: TinyNeRFConfig, cfg_p: TinyNeRFConfig):
    """Gradients of padded_tiny_widths' model (parameters() order) -> those
    of the original model: the padded entries dropped."""
    return grads if cfg_p == cfg else unpad_linears(grads, _tiny_pad_index(cfg, cfg_p))


def k1_uses_tensor_cores(cfg: TinyNeRFConfig, n_samples: int) -> bool:
    """K1's route, by configuration: bf16 with hidden a multiple of 32
    (whole 32-column warp tiles, 2 * hidden threads) and a tile of at most
    128 points padded to 128 rows (every S <= 128) whose buffer fits takes
    the tensor cores (True); f32, and bf16 off that layout, the CUDA-core
    kernel. Never raises: the render refuses no width the JAX kernel takes."""
    h = cfg.hidden
    return (cfg.compute_dtype == torch.bfloat16 and h > 0 and h % 32 == 0
            and 2 * h <= MAX_THREADS and 0 < n_samples <= TILE_POINTS
            and 4 * (TILE_POINTS * (h + cfg.in_dim) + 7 * n_samples * (TILE_POINTS // n_samples))
            <= MAX_SMEM_BYTES)


def k1_shape(cfg: TinyNeRFConfig, n_samples: int) -> Tuple[bool, bool, int, int]:
    """K1's launch by configuration, at a hidden that is a multiple of 8
    (padded_tiny_widths' width) -> (mma, general, tile rays, segment
    samples). The tensor cores where k1_uses_tensor_cores; else the
    CUDA-core kernel, one 8x8 block a thread, when its block fits
    MAX_THREADS threads and MAX_SMEM_BYTES (every S <= 128 up to hidden
    256, the recipe's included); else the general CUDA-core kernel
    (products in rounds of at most MAX_THREADS threads), on a buffer of
    the most points (a multiple of 8, at most 128) that fits: whole rays
    when S fits in it, else one ray a tile in segments of that many
    samples. Never raises: the C entry checks the shape again."""
    S, h = n_samples, cfg.hidden
    ld = h + cfg.in_dim
    tile = max(1, TILE_POINTS // S)
    P = tile * S
    if k1_uses_tensor_cores(cfg, S):
        return True, False, tile, S
    if -(-P // 8) * (h // 8) <= MAX_THREADS and 4 * (-(-P // 8) * 8 * ld + 7 * P) <= MAX_SMEM_BYTES:
        return False, False, tile, S
    p = TILE_POINTS
    while p > 8 and 4 * (p * ld + 7 * p + 5 * max(1, p // S)) > MAX_SMEM_BYTES:
        p -= 8
    return (False, True, p // S, S) if S <= p else (False, True, 1, p)


def _check_launch(params, rays_o, rays_d, n_samples, num_freqs, cfg) -> None:
    """Validate the inputs and the model against cfg (any width)."""
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (R, 3), got {tuple(x.shape)}")
    if rays_o.shape != rays_d.shape or rays_o.device != rays_d.device:
        raise ValueError("rays_o and rays_d must have the same shape and device")
    p = next(params.parameters())
    if p.device != rays_o.device:
        raise ValueError(f"params on {p.device}, rays on {rays_o.device}")
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {cfg.compute_dtype}")
    if cfg.in_dim != encoding_dim(num_freqs) or params.layers[0].in_features != cfg.in_dim:
        raise ValueError(f"in_dim {cfg.in_dim} does not match num_freqs={num_freqs}")
    if [lin.in_features for lin in params.layers] != layer_in_dims(cfg):
        raise ValueError("params do not match model_cfg (depth/skip_at/hidden)")
    if cfg.hidden < 1 or not 0 <= cfg.skip_at < cfg.depth:
        raise ValueError(f"kernel needs hidden >= 1 and 0 <= skip_at < depth, got {cfg}")
    if n_samples < 2:
        raise ValueError(f"n_samples must be >= 2, got {n_samples}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/fused_render.cu, typed for ctypes:
    every pointer and the stream as c_void_p, or ctypes would cut them
    to 32 bits."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("fused_render")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.tinynerf_fused_render.argtypes = [p] * 5 + [i] * 9 + [f, f, i, i, p]
    lib.tinynerf_fused_render.restype = i
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@spanned
def fused_render_rays(
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
) -> torch.Tensor:
    """Deterministic fused render of a ray batch -> composite RGB (R, 3).

    CUDA tensors launch the kernel (or raise): on the tensor cores where
    k1_uses_tensor_cores(cfg, n_samples), else on the CUDA cores; CPU
    tensors take fused_render_rays_plain. `model_cfg` defaults to
    params.cfg.
    """
    cfg = model_cfg or params.cfg
    kw = dict(n_samples=n_samples, near=near, far=far, num_freqs=num_freqs,
              white_bkgd=white_bkgd, model_cfg=cfg)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_render_rays_plain(params, rays_o, rays_d, **kw)
    _check_launch(params, rays_o, rays_d, n_samples, num_freqs, cfg)
    given = params
    params, cfg = padded_tiny_widths(params, cfg)
    mma, general, tile, seg = k1_shape(cfg, n_samples)

    R = rays_o.shape[0]
    pad = -R % tile
    dev = rays_o.device
    o, d = pad_rays(rays_o, rays_d, pad)
    with pack_span("fused_render_rays.pack", given):
        wts, w_mma = pack_tiny_weights(params, cfg, mma=mma)
    out = torch.empty(R + pad, 4, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("fused_render_rays.launch"):
        err = _lib().tinynerf_fused_render(
            o.data_ptr(), d.data_ptr(), wts.data_ptr(),
            None if w_mma is None else w_mma.data_ptr(), out.data_ptr(), R + pad, tile, n_samples,
            seg, int(general), num_freqs, cfg.hidden, cfg.depth, cfg.skip_at, float(near),
            float(far), int(cfg.compute_dtype == torch.bfloat16), dev.index, stream,
        )
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_render kernel launch failed: CUDA error {err} ({msg})")
    fused_render_rays.launches += 1
    fused_render_rays.mma_launches += int(mma)
    fused_render_rays.general_launches += int(general)
    comp = out[:R, :3]
    if white_bkgd:
        comp = comp + (1.0 - out[:R, 3:4])
    return comp


fused_render_rays.launches = 0  # kernel launches since the last reset
# ... of which took the tensor cores (every bf16 launch k1_uses_tensor_cores takes)
fused_render_rays.mma_launches = 0
# ... of which took the general CUDA-core kernel (k1_shape: rounds, segments)
fused_render_rays.general_launches = 0
