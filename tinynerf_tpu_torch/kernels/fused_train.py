"""Fused TinyNeRF training step: jittered depths -> encoding -> MLP ->
composite -> MSE -> backward to the parameter gradients, in one CUDA
kernel launch per step (csrc/fused_train.cu).

Replaces the Pallas TPU kernel tinynerf_tpu/kernels/fused_train.py:263
(fused_loss_grads; body _fused_train_kernel, wrapper make_fused_grad_fn,
per-ray scans from tinynerf_tpu/kernels/scans.py).

What bounds it on an H100: arithmetic, as for the render kernel, with
three products per layer instead of one (forward, weight gradient,
upstream gradient). The unfused step is bound instead by moving every
(points, 191) activation through device memory forward and back. The
kernel keeps a tile's encoding and every layer's activations in shared
memory, so only rays, targets, weights and one row of gradient partials
per block touch device memory. The partial rows are summed by a second
small kernel in a fixed order: no float atomics, so a step is
bit-identical from launch to launch. A row's stride is a multiple of 4
floats (partial_row), its padding after the loss skipped by the
reduction (dst = -1).

The route is chosen by configuration before the launch, never by a
failure (k2_uses_tensor_cores): bf16 with hidden a multiple of 32 and
tiles of exactly 64 points (S dividing 64: the recipe's S=64 is one ray a
tile) runs the three MLP products of every layer as mma.sync products on
the tensor cores (csrc/mma_bf16.cuh) from the fragments of
kernels/fused_render.py::pack_tiny_weights (forward and upstream
operands, packed with the f32 buffer from one concatenation and one
gather each, every step); f32, and bf16 off that layout, run the
CUDA-core kernel. .mma_launches counts the tensor-core launches beside
.launches.

Memory, by configuration too (k2_fits_shared_memory): a tile whose
encoding, activations and gradient fit 227 KB of shared memory keeps
them there (every recipe); larger ones (hidden 168 or 256, depth 6,
S=96 or 128, the NeRF paper's 8 x 256 trunk) take the spill route, the
same kernel code with the activation stack in a device workspace, one
slab a block; .spill_launches counts them. Any width is taken: the model
goes in zero-padded to a multiple of 8 units (padded_tiny_widths, the
gradients unpadded). Any batch: the rays are padded to whole tiles with
rays that add nothing (pad_ray_batch), and the loss divides by the real
rays.

The TPU kernel's lane layout (feature-major points, pltpu.repeat/roll
scans, the k-major encoding permutation and its inverse on the
gradients) is not carried over: the kernel computes the encoding in the
model's own order and writes each gradient in nn.Linear's (out, in)
layout, in model.parameters() order.

fused_loss_grads_plain is the same function in torch ops with
torch.autograd.grad: the CPU path of the wrapper, the tests' subject,
and the reference the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from tinynerf_tpu_torch.kernels.fused_nerf import pad8
from tinynerf_tpu_torch.kernels.fused_render import (
    MAX_SMEM_BYTES,
    pack_tiny_weights,
    padded_tiny_widths,
    unpad_tiny_grads,
)
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, layer_in_dims
from tinynerf_tpu_torch.ops.encoding import encoding_dim, positional_encoding
from tinynerf_tpu_torch.ops.volume import DELTA_INF, TRANS_EPS
from tinynerf_tpu_torch.utils.metrics import mse2psnr
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

# Points per tile: TR = TILE_POINTS // S rays of S samples (one ray at S=64).
TILE_POINTS = 64


def tile_rays(n_samples: int) -> int:
    """Rays per kernel tile (the wrapper pads the batch to whole tiles)."""
    return max(1, TILE_POINTS // n_samples)


def k2_uses_tensor_cores(cfg: TinyNeRFConfig, n_samples: int) -> bool:
    """K2's route, by configuration: bf16 with hidden a multiple of 32
    (whole 32-column warp tiles) and tiles of exactly 64 points (S divides
    64: no padding rows in a weight gradient's 64-point sum) takes the
    tensor cores (True); f32, and bf16 off that layout (S=48, hidden 48),
    the CUDA-core kernel. Never raises."""
    h = cfg.hidden
    return (cfg.compute_dtype == torch.bfloat16 and h > 0 and h % 32 == 0
            and 0 < n_samples <= TILE_POINTS and TILE_POINTS % n_samples == 0)


def k2_smem_bytes(cfg: TinyNeRFConfig, n_samples: int) -> int:
    """Shared memory of K2's shared-memory route at cfg's launched width
    (hidden rounded up to a multiple of 8), in bytes: a tile's encoding,
    every layer's activations and G (p_pad, hidden + 1) each, 15 scalars a
    point and 5 a ray (csrc/fused_train.cu's
    tinynerf_fused_train_smem_bytes)."""
    tr = tile_rays(n_samples)
    p_pad = -(-tr * n_samples // 4) * 4
    h = pad8(cfg.hidden)
    return 4 * (p_pad * cfg.in_dim + (cfg.depth + 1) * p_pad * (h + 1) + 15 * p_pad + 5 * tr)


def k2_fits_shared_memory(cfg: TinyNeRFConfig, n_samples: int) -> bool:
    """K2's memory route, by configuration: the whole tile in shared
    memory (True: every recipe, 185,108 B at hidden 128, depth 4, S=64,
    L=10), or the spill route (False), whose activation stack lives in a
    device workspace, one slab a block (hidden 168 or 256, depth 6 at
    hidden 128, S=96 or 128, the 8 x 256 trunk). Independent of the
    products' route (k2_uses_tensor_cores). Never raises."""
    return k2_smem_bytes(cfg, n_samples) <= MAX_SMEM_BYTES


def k2_route(cfg: TinyNeRFConfig, n_samples: int) -> str:
    """K2's two routes in words, at cfg's launched (padded) width."""
    cfg_k = dataclasses.replace(cfg, hidden=pad8(cfg.hidden))
    mem = "shared memory" if k2_fits_shared_memory(cfg_k, n_samples) else "spill"
    return f"{mem}, {'tensor' if k2_uses_tensor_cores(cfg_k, n_samples) else 'CUDA'} cores"


def partial_row(n_grad: int) -> int:
    """Floats of one block's row of gradient partials: n_grad values and
    the loss, padded to a multiple of 4 (8-byte float2 accesses of the
    tensor-core weight gradient stay aligned in every block's row)."""
    return (n_grad + 1 + 3) // 4 * 4


def depth_grid(n_samples: int, near: float, far: float, device) -> torch.Tensor:
    """The kernel's un-jittered depths near + s*h, h = (far-near)/(S-1)
    (not the renderer's near*(1-t) + far*t)."""
    h = (far - near) / (n_samples - 1)
    s = torch.arange(n_samples, dtype=torch.float32, device=device)
    return near + h * s


def stratified_depths(seed, n_rays: int, n_samples: int, near: float, far: float,
                      randomized: bool, device) -> torch.Tensor:
    """The train kernels' depths (n_rays, n_samples): the grid near + s*h,
    or with randomized=True one uniform draw in each of its bins (first
    and last half-bins clamped), u from a torch.Generator seeded with
    `seed` on `device`: the kernels' bins, another stream than their
    Philox draws."""
    grid = depth_grid(n_samples, near, far, device)
    if not randomized:
        return grid.expand(n_rays, n_samples)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((n_rays, n_samples), generator=gen, dtype=torch.float32, device=device)
    h = (far - near) / (n_samples - 1)
    s = torch.arange(n_samples, device=device)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == n_samples - 1, grid, grid + 0.5 * h)
    return lower + (upper - lower) * u


def fused_loss_grads_plain(
    model: TinyNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seed,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The kernel's semantics in torch ops -> (loss, grads aligned to
    model.parameters()).

    randomized=False: the depth grid near + s*h. randomized=True: the
    same stratified bins (first and last half-bins clamped), with u drawn
    by a torch.Generator seeded with `seed` on the rays' device: the same
    bins as the kernel's Philox draws, a different stream. sigma_noise
    (R, S) is added to the raw density before the ReLU. Deltas are
    z_next - z with the 1e10 terminal, times ||d||.
    """
    cfg = model_cfg or model.cfg
    R, S = rays_o.shape[0], n_samples
    z = stratified_depths(seed, R, S, near, far, randomized, rays_o.device)
    norm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    gap = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], DELTA_INF)], dim=-1)
    delta = gap * norm
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    enc = positional_encoding(pts.reshape(-1, 3), num_freqs=num_freqs)
    noise = None if sigma_noise is None else sigma_noise.reshape(-1, 1).float()
    params = list(model.parameters())
    with torch.enable_grad():
        rgb, sigma = model(enc, cfg, sigma_noise=noise)
        rgb = rgb.reshape(R, S, 3)
        sigma = sigma.reshape(R, S)
        one_m = torch.exp(-sigma * delta) + TRANS_EPS
        alpha = 1.0 - (one_m - TRANS_EPS)
        trans = torch.cumprod(one_m, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        w = alpha * trans
        comp = torch.sum(w[..., None] * rgb, dim=-2)
        if white_bkgd:
            comp = comp + (1.0 - torch.sum(w, dim=-1, keepdim=True))
        loss = torch.mean((comp - target.float()) ** 2)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), list(grads)


def pack_backward_weights(model: TinyNeRF, cfg: TinyNeRFConfig) -> torch.Tensor:
    """Trunk layers 1..depth-1, each W[:, :hidden] in nn.Linear's own
    (out, in) layout (the rows the upstream gradient needs; the skip
    layer's encoding rows get no gradient), rounded to compute_dtype.
    Stacked scenes give (K, n), a row a scene."""
    lead = model.layers[0].weight.shape[:-2]
    parts = [
        lin.weight.detach()[..., : cfg.hidden].to(cfg.compute_dtype).float().reshape(*lead, -1)
        for lin in list(model.layers)[1:]
    ]
    if not parts:
        return torch.zeros(*lead, cfg.hidden * cfg.hidden, device=model.layers[0].weight.device)
    return torch.cat(parts, dim=-1).contiguous()


def grad_layout(cfg: TinyNeRFConfig) -> dict:
    """Parameter name -> index tensor (the parameter's shape) into the
    kernel's gradient layout, which is pack_weights' layout: per trunk
    layer W (in, hidden) then b, then the head W (hidden, 4) with columns
    r, g, b, sigma, then its 4 biases."""
    h = cfg.hidden
    out, off = {}, 0
    for i, n_in in enumerate(layer_in_dims(cfg)):
        out[f"layers.{i}.weight"] = off + torch.arange(n_in * h).reshape(n_in, h).t()
        out[f"layers.{i}.bias"] = off + n_in * h + torch.arange(h)
        off += (n_in + 1) * h
    head = off + torch.arange(h * 4).reshape(h, 4).t()  # (4, hidden)
    out["rgb.0.weight"], out["sigma.0.weight"] = head[:3], head[3:]
    out["rgb.0.bias"] = off + 4 * h + torch.arange(3)
    out["sigma.0.bias"] = off + 4 * h + torch.tensor([3])
    return out


@functools.lru_cache(maxsize=None)
def _scatter_index(names: tuple, cfg: TinyNeRFConfig, device: torch.device) -> torch.Tensor:
    """dst (partial_row(n_grad),) int32: kernel-layout index -> position
    in the flat output (the parameters in `names` order, the loss last;
    -1 for the row's padding)."""
    layout = grad_layout(cfg)
    if sorted(names) != sorted(layout):
        raise ValueError(f"unexpected parameters {names}")
    src = torch.cat([layout[n].reshape(-1) for n in names])
    n = src.numel()
    dst = torch.full((partial_row(n),), -1, dtype=torch.int64)
    dst[src] = torch.arange(n)
    dst[n] = n
    return dst.to(torch.int32).to(device)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/fused_train.cu, typed for ctypes:
    every pointer and the stream as c_void_p."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("fused_train")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    ll = ctypes.c_longlong
    lib.tinynerf_fused_train.argtypes = ([p] * 11 + [i] * 7 + [f] * 3 + [i] * 7 + [ll] * 3
                                         + [i, p, i, p])
    lib.tinynerf_fused_train.restype = i
    lib.tinynerf_fused_train_jitter.argtypes = [p, p, i, i, i, f, f, i, p]
    lib.tinynerf_fused_train_jitter.restype = i
    lib.tinynerf_fused_train_spill_smem_bytes.argtypes = [i] * 5
    lib.tinynerf_fused_train_spill_smem_bytes.restype = i
    lib.tinynerf_fused_train_workspace_floats.argtypes = [i] * 7
    lib.tinynerf_fused_train_workspace_floats.restype = ll
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _seed_tensor(seed, device: torch.device) -> torch.Tensor:
    """The int32 seed as one device int (a device tensor stays on the
    device: no host sync)."""
    if isinstance(seed, torch.Tensor):
        if seed.device != device or seed.numel() != 1:
            raise ValueError(f"seed tensor must hold one value on {device}")
        return seed.reshape(1).to(torch.int32).contiguous()
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def _seeds_tensor(seeds, n_scenes: int, device: torch.device) -> torch.Tensor:
    """The scenes' int32 seeds as a (K,) device tensor (a device tensor
    stays on the device: no host sync)."""
    if isinstance(seeds, torch.Tensor):
        if seeds.device != device or seeds.numel() != n_scenes:
            raise ValueError(f"seeds must hold {n_scenes} values on {device}")
        return seeds.reshape(n_scenes).to(torch.int32).contiguous()
    seeds = [int(x) for x in seeds]
    if len(seeds) != n_scenes:
        raise ValueError(f"{len(seeds)} seeds for {n_scenes} scenes")
    return torch.tensor(seeds, dtype=torch.int32, device=device)


def _check_launch(model, tensors, n_samples, num_freqs, cfg) -> None:
    dev = tensors["rays_o"].device
    for name, x in tensors.items():
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    *lead, R, _ = tensors["rays_o"].shape  # lead: (K,) for stacked scenes
    for name in ("rays_o", "rays_d", "target"):
        if tuple(tensors[name].shape) != (*lead, R, 3):
            raise ValueError(f"{name} must be {(*lead, R, 3)}, got {tuple(tensors[name].shape)}")
    if "sigma_noise" in tensors and tuple(tensors["sigma_noise"].shape) != (*lead, R, n_samples):
        raise ValueError(f"sigma_noise must be {(*lead, R, n_samples)}")
    if next(model.parameters()).device != dev:
        raise ValueError(f"model on {next(model.parameters()).device}, rays on {dev}")
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {cfg.compute_dtype}")
    if cfg.in_dim != encoding_dim(num_freqs) or [l.in_features for l in model.layers] != layer_in_dims(cfg):
        raise ValueError(f"model does not match model_cfg {cfg} at num_freqs={num_freqs}")
    if cfg.hidden < 1 or not 0 <= cfg.skip_at < cfg.depth:
        raise ValueError(f"kernel needs hidden >= 1 and 0 <= skip_at < depth, got {cfg}")


@spanned
def fused_loss_grads(
    model: TinyNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seed,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    spill: Optional[bool] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One training step's (mse_loss, grads aligned to model.parameters()).

    CUDA tensors launch the kernel (or raise): on the tensor cores where
    k2_uses_tensor_cores, else on the CUDA cores; with the tile in shared
    memory where k2_fits_shared_memory, else on the spill route (`spill`
    True or False forces a memory route, to compare the two). Any width
    (padded_tiny_widths) and any batch (masked ray padding) is taken. CPU
    tensors take fused_loss_grads_plain. `seed` is an int or a
    one-element int tensor on the rays' device (the jitter's Philox key).
    """
    cfg = model_cfg or model.cfg
    if rays_o.shape[0] == 0:
        raise ValueError("n_rand must be positive")
    if n_samples < 2:
        raise ValueError(f"n_samples must be >= 2, got {n_samples}")
    kw = dict(sigma_noise=sigma_noise, n_samples=n_samples, near=near, far=far,
              randomized=randomized, num_freqs=num_freqs, white_bkgd=white_bkgd, model_cfg=cfg)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_loss_grads_plain(model, rays_o, rays_d, target, seed, **kw)
    loss, grads = _launch(model, rays_o[None], rays_d[None], target[None],
                          _seed_tensor(seed, rays_o.device),
                          None if sigma_noise is None else sigma_noise[None], n_samples, near, far,
                          randomized, num_freqs, white_bkgd, cfg, spill, scenes=False)
    return loss[0], grads


fused_loss_grads.launches = 0  # kernel launches since the last reset
# ... of which took the tensor cores (every bf16 launch k2_uses_tensor_cores takes)
fused_loss_grads.mma_launches = 0
# ... of which took the spill route (every launch k2_fits_shared_memory refuses)
fused_loss_grads.spill_launches = 0
# ... of which trained a stack of scenes in one launch (fused_loss_grads_scenes)
fused_loss_grads.scene_launches = 0


def scene_slabs(w: Optional[torch.Tensor], K: int) -> Optional[torch.Tensor]:
    """A packed weight buffer as (K, n) rows, one slab a scene; with K > 1
    each row zero-padded to a multiple of 4 values, so that every scene's
    slab starts 16-byte aligned (8-byte in bf16) for the kernels' vector
    loads of the weights (the C entries check the stride)."""
    if w is None:
        return None
    w = w.reshape(K, -1)
    pad = -w.shape[1] % 4 if K > 1 else 0
    return torch.nn.functional.pad(w, (0, pad)) if pad else w


def _split_grads(flat: torch.Tensor, params) -> List[torch.Tensor]:
    """Views of `flat` (..., n) shaped as each parameter in turn; a
    stacked parameter (K, *shape) takes (K, *shape) of a (K, n) buffer."""
    grads, off = [], 0
    for p in params:
        n = p[0].numel() if flat.dim() == 2 else p.numel()
        grads.append(flat[..., off:off + n].reshape(p.shape))
        off += n
    return grads


def pad_ray_batch(rays_o, rays_d, target, sigma_noise, pad: int, white_bkgd: bool):
    """(K, R, .) inputs with `pad` rays appended to each scene that add
    nothing to the loss or to any gradient: origin and direction 0, so
    every delta is 0, every alpha exactly 0 and the composite exactly the
    background, which is the target (1 with a white background, else 0);
    the residual and every gradient term of such a ray are zeros. Real
    rays keep their indices, so the jitter's (seed, ray, sample) draws do
    not change."""
    if not pad:
        return rays_o, rays_d, target, sigma_noise
    K = rays_o.shape[0]

    def cat(x, fill, width):
        return torch.cat([x, x.new_full((K, pad, width), fill)], dim=1).contiguous()

    noise = None if sigma_noise is None else cat(sigma_noise, 0.0, sigma_noise.shape[-1])
    return (cat(rays_o, 0.0, 3), cat(rays_d, 0.0, 3),
            cat(target, 1.0 if white_bkgd else 0.0, 3), noise)


def _launch(model, rays_o, rays_d, target, seeds, sigma_noise, n_samples, near, far, randomized,
            num_freqs, white_bkgd, cfg, spill: Optional[bool], scenes: bool):
    """Launch K2 over K stacked scenes and count it: rays_o, rays_d,
    target (K, R, 3), seeds (K,) int32 on the device, sigma_noise (K, R,
    S) or None; `model` holds one scene (scenes=False, K = 1) or K stacked
    ones -> (loss (K,), grads aligned to model.parameters(): one scene's,
    or each (K, *shape)). The model is padded to a multiple of 8 units
    (padded_tiny_widths) and each scene's rays to whole tiles
    (pad_ray_batch); the loss divides by the real rays. Spans: the
    wrapper's .pack and .launch."""
    name = "fused_loss_grads_scenes" if scenes else "fused_loss_grads"
    tensors = {"rays_o": rays_o, "rays_d": rays_d, "target": target}
    if sigma_noise is not None:
        tensors["sigma_noise"] = sigma_noise
    _check_launch(model, tensors, n_samples, num_freqs, cfg)
    model_k, cfg_k = padded_tiny_widths(model, cfg)

    dev = rays_o.device
    K, R = rays_o.shape[:2]
    tr = tile_rays(n_samples)
    pad = -R % tr
    rays_o, rays_d, target, sigma_noise = pad_ray_batch(rays_o, rays_d, target, sigma_noise, pad,
                                                        white_bkgd)
    mma = k2_uses_tensor_cores(cfg_k, n_samples)
    if spill is None:
        spill = not k2_fits_shared_memory(cfg_k, n_samples)
    lib = _lib()
    wide = int(mma)  # the tensor cores keep the encoding inside the stack
    smem = (lib.tinynerf_fused_train_spill_smem_bytes(tr, n_samples, num_freqs, cfg_k.skip_at, wide)
            if spill else k2_smem_bytes(cfg_k, n_samples))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a tile of {tr} rays x {n_samples} samples needs {smem} B of shared "
                         f"memory on the {'spill' if spill else 'shared-memory'} route: too large")
    # The tensor cores read the upstream products' weights as fragments only;
    # each buffer is packed once for every scene, (K, n).
    with pack_span(name + ".pack", model):
        w_fwd, w_mma = pack_tiny_weights(model_k, cfg_k, mma=mma, upstream=True)
        w_bwd = None if mma else pack_backward_weights(model_k, cfg_k)
        n_grad = w_fwd.shape[-1]
        w_fwd, w_mma, w_bwd = (scene_slabs(w, K) for w in (w_fwd, w_mma, w_bwd))
    # Blocks per scene, independent of K: a scene's reduction order, and so
    # its loss and gradients, do not depend on the scenes beside it.
    n_blocks = min((R + pad) // tr, torch.cuda.get_device_properties(dev).multi_processor_count)
    row = partial_row(n_grad)
    partials = torch.empty(K, n_blocks, row, dtype=torch.float32, device=dev)
    ws = None
    if spill:
        slab = lib.tinynerf_fused_train_workspace_floats(tr, n_samples, num_freqs, cfg_k.hidden,
                                                         cfg_k.depth, cfg_k.skip_at, wide)
        ws = torch.empty(K * n_blocks * slab, dtype=torch.float32, device=dev)
    out = torch.empty(K, n_grad + 1, dtype=torch.float32, device=dev)
    names = tuple(n for n, _ in model_k.named_parameters())
    dst = _scatter_index(names, cfg_k, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span(name + ".launch"):
        err = lib.tinynerf_fused_train(
            rays_o.data_ptr(), rays_d.data_ptr(), target.data_ptr(),
            None if sigma_noise is None else sigma_noise.data_ptr(), seeds.data_ptr(),
            w_fwd.data_ptr(), None if w_bwd is None else w_bwd.data_ptr(),
            None if w_mma is None else w_mma.data_ptr(), partials.data_ptr(), dst.data_ptr(),
            out.data_ptr(), R + pad, tr, n_samples, num_freqs, cfg_k.hidden, cfg_k.depth,
            cfg_k.skip_at, float(near), (far - near) / (n_samples - 1), 1.0 / (R * 3),
            int(randomized), int(white_bkgd), int(cfg_k.compute_dtype == torch.bfloat16),
            n_blocks, n_grad, row, K, w_fwd.shape[1], 0 if w_bwd is None else w_bwd.shape[1],
            0 if w_mma is None else w_mma.shape[1], int(spill),
            None if ws is None else ws.data_ptr(), dev.index, stream,
        )
    _raise_on(err, "fused_train kernel")
    fused_loss_grads.launches += 1
    fused_loss_grads.mma_launches += int(mma)
    fused_loss_grads.spill_launches += int(spill)
    grads = _split_grads(out[:, :n_grad] if scenes else out[0, :n_grad], model_k.parameters())
    return out[:, n_grad], unpad_tiny_grads(grads, cfg, cfg_k)


def fused_loss_grads_scenes_plain(model, rays_o, rays_d, target, seeds, *,
                                  sigma_noise: Optional[torch.Tensor] = None, **kw):
    """fused_loss_grads_scenes in torch ops: fused_loss_grads_plain on
    each scene in turn (scene k's weights, rays, seeds[k]) -> (loss (K,),
    grads aligned to model.parameters(), each (K, *shape)). The CPU path
    and the tests' subject; no main path runs it when a card is present."""
    from tinynerf_tpu_torch.models.stacked import per_scene

    return per_scene(fused_loss_grads_plain, model, (rays_o, rays_d, target, seeds),
                     dict(sigma_noise=sigma_noise), **kw)


@spanned
def fused_loss_grads_scenes(
    model: TinyNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    seeds,
    *,
    sigma_noise: Optional[torch.Tensor] = None,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    randomized: bool = True,
    num_freqs: int = 10,
    white_bkgd: bool = True,
    model_cfg: Optional[TinyNeRFConfig] = None,
    spill: Optional[bool] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """One training step of K stacked scenes in one launch -> (loss (K,),
    grads aligned to model.parameters(), each (K, *shape)).

    `model` holds K TinyNeRFs stacked on a leading axis (multiscene.py);
    rays_o, rays_d, target are (K, R, 3), seeds K int32 seeds (a (K,)
    device tensor or ints), sigma_noise (K, R, S). Scene k's loss and
    gradients are bit-identical to fused_loss_grads on its own weights and
    inputs with seeds[k]: its draws are keyed by scene-local rays and its
    blocks do not depend on K. The weights are packed once for all scenes.
    Widths, batches and routes as fused_loss_grads'. CUDA tensors launch
    the kernel (or raise; .launches counts one, and .scene_launches one);
    CPU tensors take fused_loss_grads_scenes_plain."""
    cfg = model_cfg or model.cfg
    if rays_o.dim() != 3:
        raise ValueError(f"rays_o must be (K, R, 3), got {tuple(rays_o.shape)}")
    K, R = rays_o.shape[:2]
    if R == 0:
        raise ValueError("n_rand must be positive")
    if n_samples < 2:
        raise ValueError(f"n_samples must be >= 2, got {n_samples}")
    if any(p.shape[0] != K for p in model.parameters()):
        raise ValueError(f"the model must stack {K} scenes on every parameter's first axis")
    kw = dict(n_samples=n_samples, near=near, far=far, randomized=randomized,
              num_freqs=num_freqs, white_bkgd=white_bkgd, model_cfg=cfg)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_loss_grads_scenes_plain(model, rays_o, rays_d, target, seeds,
                                             sigma_noise=sigma_noise, **kw)
    res = _launch(model, rays_o, rays_d, target, _seeds_tensor(seeds, K, rays_o.device),
                  sigma_noise, n_samples, near, far, randomized, num_freqs, white_bkgd, cfg, spill,
                  scenes=True)
    fused_loss_grads.scene_launches += 1
    return res


def jitter_probe(seed, n_rays: int, n_samples: int, near: float, far: float,
                 tile: int, device) -> torch.Tensor:
    """The depths (n_rays, n_samples) that the kernel's own sample_depth
    draws for `seed`, computed in blocks of `tile` rays. For the jitter
    statistics checks only (chip_smoke.py, the card tests)."""
    dev = torch.device(device)
    if dev.type != "cuda" or n_rays % tile:
        raise ValueError("jitter_probe needs a CUDA device and n_rays % tile == 0")
    z = torch.empty(n_rays, n_samples, dtype=torch.float32, device=dev)
    seed_t = _seed_tensor(seed, dev)
    err = _lib().tinynerf_fused_train_jitter(
        z.data_ptr(), seed_t.data_ptr(), n_rays, tile, n_samples, float(near),
        (far - near) / (n_samples - 1), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "jitter probe")
    return z


def draw_step_inputs(generator: torch.Generator, n_rays: int, noise_widths, noise_std: float,
                     noise_scale: float, device) -> tuple:
    """One scene's draws for a fused step, from its generator in the JAX
    package's order: a sigma-noise (n_rays, n) for each n of noise_widths
    (when noise_std > 0; else None each), then the int32 kernel seed (1,),
    drawn on the generator's device (no host sync) and moved to `device`
    -> (*noises, seed)."""
    gdev = generator.device
    noises = [None] * len(noise_widths)
    if noise_std > 0.0:
        noises = [(noise_scale * noise_std * torch.randn(
            (n_rays, n), generator=generator, dtype=torch.float32, device=gdev)).to(device)
            for n in noise_widths]
    seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, dtype=torch.int32,
                         device=gdev).to(device)
    return (*noises, seed)


def join_scenes(draws: list, scenes: bool) -> tuple:
    """The draw_step_inputs of each scene as one launch's inputs: one
    scene's own, or K scenes' noises stacked (K, R, n) and seeds
    concatenated (K,); None stays None."""
    if not scenes:
        return draws[0]
    *noises, seeds = zip(*draws)
    return (*(None if n[0] is None else torch.stack(n) for n in noises), torch.cat(seeds))


def _make_grad_fn(s, randomized: bool, scenes: bool):
    noise_std = s.sigma_noise_std
    loss_grads = fused_loss_grads_scenes if scenes else fused_loss_grads

    def grad_fn(model, ro, rd, target, generators, noise_scale=1.0):
        noise, seed = join_scenes([
            draw_step_inputs(gen, ro.shape[-2], (s.n_samples,), noise_std, noise_scale,
                             ro.device)
            for gen in (generators if scenes else [generators])], scenes)
        loss, grads = loss_grads(
            model, ro, rd, target, seed, sigma_noise=noise, n_samples=s.n_samples,
            near=s.near, far=s.far, randomized=randomized, num_freqs=s.num_freqs,
            white_bkgd=s.white_bkgd, model_cfg=s.model_cfg,
        )
        for p, g in zip(model.parameters(), grads):
            p.grad = g
        return loss, {"loss": loss, "psnr": mse2psnr(loss)}

    return grad_fn


def make_fused_grad_fn(s, randomized: bool = True):
    """(model, ro, rd, target, generator, noise_scale=1.0) -> (loss,
    metrics), writing each parameter's .grad: the drop-in for
    training.loss_fn + backward. The generator draws the sigma-noise
    (R, S) only when s.sigma_noise_std > 0, then the int32 kernel seed
    (draw_step_inputs)."""
    return _make_grad_fn(s, randomized, scenes=False)


def make_fused_grad_fn_scenes(s, randomized: bool = True):
    """The multi-scene make_fused_grad_fn: (model of K stacked scenes, ro,
    rd, target (K, R, 3), generators (K scene generators), noise_scale=1.0)
    -> (loss (K,), metrics of (K,)), writing each stacked parameter's .grad
    from one fused_loss_grads_scenes launch. Scene k's generator draws what
    make_fused_grad_fn's does, by the same draw_step_inputs, so scene k
    trains as a one-scene run on its own generator."""
    return _make_grad_fn(s, randomized, scenes=True)
