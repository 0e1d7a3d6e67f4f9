"""Fused full-NeRF MLP render pass (K3) and the fused hierarchical
pipeline, on one CUDA kernel (csrc/fused_nerf.cu).

fused_nerf_render_rays replaces the Pallas TPU kernel
tinynerf_tpu/kernels/fused_nerf.py:183 (body _nerf_kernel):
points (from analytic linspace depths or given (R, S) depths) ->
encoding -> trunk with skip -> sigma head -> view-direction branch ->
rgb head -> alpha composite, optionally with the (R, S) per-sample
weights that hierarchical resampling reads.

fused_render_rays_hierarchical is the deterministic coarse -> resample
-> fine pipeline of tinynerf_tpu/kernels/fused_nerf.py:280-362: the
coarse pass through K3 with weights out, sample_pdf and the sort in
torch, then the fine pass through K3, or through the streamed K5
(kernels/fused_nerf_stream.py) when hidden * S_union > 128 * 384, the
JAX package's routing rule.

What bounds it on an H100, and the kernel's layout: see the header of
csrc/fused_nerf.cu. The TPU kernel's encoding row permutations
(_encode_permutation, _dir_permutation) are not carried over: the
kernel computes both encodings in the model's interleaved order.

The route is chosen by configuration before the launch, never by a
failure (render_uses_tensor_cores): bf16 at the widths the tensor-core
products take (mma_shapes_ok: hidden a multiple of 32, 4 * rgb_hidden /
hidden in {1, 2, 4}; every recipe of the repo) runs the trunk and rgb_in
as mma.sync products (csrc/mma_bf16.cuh) from the fragments of
pack_mma_forward, packed for each launch; f32, and the few bf16 widths
off that layout, run the CUDA-core kernel, at any width: widths that are
not multiples of 8 go to it zero-padded (padded_widths; exact, since a
padded column is ReLU(0) = 0 and the next layer's padded rows are 0), and
the K3-K7 wrappers drop the padded gradient entries (unpad_grads).
.mma_launches counts the tensor-core launches beside .launches. The
fragment packer (mma_operands, pack_mma_b) lives here and serves the
training kernels too.

The shape is chosen by configuration too (nerf_shape, the rule of K3-K7):
the one-round kernel where its block of 2 * max(hidden, rgb_hidden)
threads fits 512 and 227 KB (every recipe of the repo), else the general
kernel (512 threads, the products in rounds of whole point groups), with
its buffer X in a device slab a block (the spill route) where X passes
227 KB (hidden 384 and past). Every width and sample count the JAX
kernels take launches; .general_launches and .spill_launches count those
routes. default_sample_block, the fine pass's block, is total: the JAX
package's rule where it yields a block, else a divisor of at least 8 (or
the whole union).

fused_nerf_render_rays_plain is the same computation in torch ops: the
CPU path of the wrapper and the reference the kernel is checked against
on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional

import torch

from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, NeRFMLP, nerf_layer_in_dims, run_mlp, view_encoding
from tinynerf_tpu_torch.models.stacked import with_params
from tinynerf_tpu_torch.ops.sampling import sample_pdf
from tinynerf_tpu_torch.ops.volume import DELTA_INF, TRANS_EPS
from tinynerf_tpu_torch.utils.profiling import pack_span, span, spanned

MAX_SMEM_BYTES = 232448  # H100: 227 KB of dynamic shared memory per block
# The NeRF kernels' block limits (csrc/nerf_mlp.cuh): 128-point forward
# chunks, at most 512 threads, and the general kernels' widest width (a
# round holds at least one point group's max(hidden, rgb_hidden) / 8 items).
TILE_POINTS = 128
MAX_THREADS = 512
MAX_GENERAL_WIDTH = 8 * MAX_THREADS
# The training walk's scalars per point and per ray (csrc/nerf_train_walk.cuh).
WALK_POINT_SCALARS = 13
WALK_RAY_SCALARS = 20
# The fine pass streams (K5) above this many hidden units x union samples
# (tinynerf_tpu/kernels/fused_nerf.py:326).
STREAM_ABOVE = 128 * 384


def composite_one_m(rgb: torch.Tensor, sigma: torch.Tensor, delta: torch.Tensor,
                    t_in: Optional[torch.Tensor] = None):
    """The kernels' composite: one_m = exp(-sigma delta) + 1e-10,
    alpha = 1 - (one_m - 1e-10), trans = t_in * (exclusive product of
    one_m along the samples), t_in (R,) the entry transmittance (1 when
    None) -> (comp_raw (R, 3), acc (R,), weights (R, S), inclusive
    product of one_m over the samples (R,))."""
    one_m = torch.exp(-sigma * delta) + TRANS_EPS
    alpha = 1.0 - (one_m - TRANS_EPS)
    incl = torch.cumprod(one_m, dim=-1)
    trans = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], dim=-1)
    if t_in is not None:
        trans = t_in[:, None] * trans
    w = alpha * trans
    return torch.sum(w[..., None] * rgb, dim=-2), torch.sum(w, dim=-1), w, incl[:, -1]


def deltas(z: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """(z_{s+1} - z_s) * ||d||, with DELTA_INF * ||d|| for the last sample."""
    dz = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], DELTA_INF)], dim=-1)
    return dz * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)


def linspace_depths(n_samples: int, near: float, far: float, device) -> torch.Tensor:
    """The kernel's analytic depths z_s = near (1 - t) + far t, t = s/(S-1)."""
    t = torch.arange(n_samples, dtype=torch.float32, device=device) / (n_samples - 1)
    return near * (1.0 - t) + far * t


def fused_nerf_render_rays_plain(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: Optional[torch.Tensor] = None,
    *,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    return_weights: bool = False,
):
    """K3's semantics in torch ops -> comp_rgb (R, 3) (+ weights (R, S))."""
    cfg = cfg or mlp.cfg
    R = rays_o.shape[0]
    if z_vals is None:
        z_vals = linspace_depths(n_samples, near, far, rays_o.device).expand(R, n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    rgb, sigma = run_mlp(mlp, pts, view_encoding(rays_d, cfg), cfg)
    comp, acc, w, _ = composite_one_m(rgb, sigma, deltas(z_vals, rays_d))
    if white_bkgd:
        comp = comp + (1.0 - acc[:, None])
    return (comp, w) if return_weights else comp


def pack_nerf_weights(mlp: NeRFMLP, cfg: NeRFConfig) -> torch.Tensor:
    """One MLP's weights as one f32 buffer in the kernel's order: per
    trunk layer W (in, out) then b; sigma W (hidden) then b and 3 zeros
    (16-byte alignment for what follows); rgb_in W (hidden + dir_dim,
    rgb_hidden) then b; rgb W (rgb_hidden, 3) then b. Weights are
    rounded to bf16 when the compute dtype is bf16; biases stay f32.
    The rows stay in the model's interleaved encoding order. An MLP of
    stacked scenes (weights (K, out, in), multiscene.py) gives one such
    buffer a scene, (K, n), from one concatenation."""
    lead = mlp.sigma.weight.shape[:-2]

    def w(lin):
        return lin.weight.detach().to(cfg.compute_dtype).float().transpose(-1, -2).reshape(*lead, -1)

    def b(lin):
        return lin.bias.detach().float()

    parts = []
    for lin in mlp.layers:
        parts += [w(lin), b(lin)]
    parts += [w(mlp.sigma), b(mlp.sigma), b(mlp.sigma).new_zeros(*lead, 3)]
    parts += [w(mlp.rgb_in), b(mlp.rgb_in), w(mlp.rgb), b(mlp.rgb)]
    return torch.cat(parts, dim=-1).contiguous()


def mma_shapes_ok(cfg: NeRFConfig) -> bool:
    """Whether the tensor-core products (csrc/mma_bf16.cuh: mma_dense_relu)
    take cfg's widths: warps own whole 32-column tiles of a trunk layer's
    output, and hidden / 32 warps share rgb_in's columns in 1, 2 or 4 whole
    8-column tiles each; the general kernels' 16 warps hold a 64-row half's
    hidden / 32 tiles a round, so hidden <= 512 (wider bf16 takes the CUDA
    cores, as hidden 48 does). Never raises."""
    h, rh = cfg.hidden, cfg.rgb_hidden
    return (0 < h <= 32 * (MAX_THREADS // 32) and h % 32 == 0 and (4 * rh) % h == 0
            and 4 * rh // h in (1, 2, 4))


def render_uses_tensor_cores(cfg: NeRFConfig) -> bool:
    """The route of K3 and K5, by configuration: bf16 at widths the
    tensor-core products take (True), else the CUDA-core kernel (f32, and
    bf16 widths such as hidden 48). Never raises: the render refuses no
    width the JAX kernel takes."""
    return cfg.compute_dtype == torch.bfloat16 and mma_shapes_ok(cfg)


def mma_operands(mlp: NeRFMLP, cfg: NeRFConfig) -> List[tuple]:
    """The B operands (K, N) of the tensor-core products in packing order,
    as (name, bf16 matrix): each trunk layer's and rgb_in's forward W^T
    (in, out), then the upstream W[:, :hidden] (out, hidden) of trunk
    layers 1..depth-1 and of rgb_in (the skip layer's encoding rows and
    rgb_in's direction rows get no upstream gradient). Stacked scenes keep
    their leading axis: (K, K_op, N) each."""
    h = cfg.hidden
    named = [(f"layers.{i}", lin) for i, lin in enumerate(mlp.layers)] + [("rgb_in", mlp.rgb_in)]
    ws = {n: lin.weight.detach().to(torch.bfloat16) for n, lin in named}
    out = [(f"{n}.fwd", ws[n].transpose(-1, -2)) for n, _ in named]
    return out + [(f"{n}.up", ws[n][..., :h]) for n, _ in named[1:]]


def pack_mma_b(b: torch.Tensor) -> torch.Tensor:
    """One (K, N) B operand as the tensor-core products read it
    (csrc/mma_bf16.cuh): K zero-padded to a multiple of 32, then for each
    16-deep k-step ks, each 8-column tile nt and each lane (g = lane // 4,
    t = lane % 4) the 4 values B[32 (ks // 2) + 8 t + 4 (ks % 2) + j][8 nt
    + g], j = 0..3: one 8-byte load per lane. Flat, same dtype; leading
    (scene) axes stay: (..., K, N) -> (..., n)."""
    *lead, K, N = b.shape
    kp = -(-K // 32) * 32
    b = torch.cat([b, b.new_zeros(*lead, kp - K, N)], dim=-2)
    # (p, t, h, j, nt, g) -> (p, h, nt, g, t, j): ks = 2 p + h, lane = 4 g + t
    n = len(lead)
    perm = [*range(n), *(n + i for i in (0, 2, 4, 5, 1, 3))]
    return b.reshape(*lead, kp // 32, 4, 2, 4, N // 8, 8).permute(*perm).reshape(*lead, -1)


def pack_mma_forward(mlp: NeRFMLP, cfg: NeRFConfig) -> torch.Tensor:
    """The w_mma buffer of a tensor-core K3/K5 launch (bf16): the forward
    operands of mma_operands (the first depth + 1: the trunk layers' and
    rgb_in's W^T), packed by pack_mma_b and concatenated. It is the prefix
    of the training kernels' pack_mma_weights, so csrc/mma_bf16.cuh's
    mma_fwd_off serves both."""
    return torch.cat([pack_mma_b(b) for name, b in mma_operands(mlp, cfg)
                      if name.endswith(".fwd")], dim=-1).contiguous()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/fused_nerf.cu, typed for ctypes:
    every pointer and the stream as c_void_p, or ctypes would cut them
    to 32 bits."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("fused_nerf")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.tinynerf_fused_nerf.argtypes = [p] * 7 + [i] * 10 + [f, f, i, i, p, i, i, p]
    lib.tinynerf_fused_nerf.restype = i
    lib.tinynerf_fused_nerf_streamed.argtypes = [p] * 7 + [i] * 13 + [p, i, i, p]
    lib.tinynerf_fused_nerf_streamed.restype = i
    lib.tinynerf_fused_nerf_smem_bytes.argtypes = [i] * 8
    lib.tinynerf_fused_nerf_smem_bytes.restype = i
    lib.tinynerf_fused_nerf_spill_floats.argtypes = [i] * 5
    lib.tinynerf_fused_nerf_spill_floats.restype = ctypes.c_longlong
    lib.tinynerf_fused_nerf_threads.argtypes = [i] * 3
    lib.tinynerf_fused_nerf_threads.restype = i
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def check_mlp(mlp: NeRFMLP, cfg: NeRFConfig) -> None:
    """Validate the MLP against cfg and the dtype against what the NeRF
    kernels (K3-K7) take. Any positive width is taken (padded_widths)."""
    if cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {cfg.compute_dtype}")
    if ([lin.in_features for lin in mlp.layers] != nerf_layer_in_dims(cfg)
            or mlp.layers[0].out_features != cfg.hidden
            or mlp.rgb_in.in_features != cfg.hidden + cfg.dir_dim
            or mlp.rgb_in.out_features != cfg.rgb_hidden):
        raise ValueError("params do not match cfg (num_freqs/depth/skip_at/hidden/viewdirs)")
    if cfg.hidden < 1 or cfg.rgb_hidden < 1 or not 0 <= cfg.skip_at < cfg.depth:
        raise ValueError(f"kernel needs hidden, rgb_hidden >= 1 and 0 <= skip_at < depth, got {cfg}")


def check_inputs(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, z) -> None:
    """Validate the rays, the depths and the MLP against what the NeRF
    kernels (K3-K7) take."""
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (R, 3), got {tuple(x.shape)}")
    if rays_o.shape != rays_d.shape or rays_o.device != rays_d.device:
        raise ValueError("rays_o and rays_d must have the same shape and device")
    if z is not None:
        if z.device != rays_o.device or z.dtype != torch.float32:
            raise TypeError(f"z_vals must be float32 on {rays_o.device}, got {z.dtype} on {z.device}")
        if z.dim() != 2 or z.shape[0] != rays_o.shape[0]:
            raise ValueError(f"z_vals must be (R, S), got {tuple(z.shape)}")
    p = next(mlp.parameters())
    if p.device != rays_o.device:
        raise ValueError(f"params on {p.device}, rays on {rays_o.device}")
    check_mlp(mlp, cfg)


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def block_threads(cfg: NeRFConfig) -> int:
    """Threads of a K3-K7 block (csrc/nerf_mlp.cuh: block_threads), at
    widths that are multiples of 8: one per 8x8 block of the widest
    (128, n) product."""
    return 2 * max(cfg.hidden, cfg.rgb_hidden)


def _pad_index(cfg: NeRFConfig, cfg_p: NeRFConfig) -> dict:
    """Layer name -> (rows, columns) of its weight (out, in) inside the
    padded layer's: the hidden units keep their index, the encoding's and
    the direction encoding's columns follow the padded hidden ones."""
    h, hp, rh = cfg.hidden, cfg_p.hidden, cfg.rgb_hidden

    def after_h(n_extra):
        return torch.cat([torch.arange(h), hp + torch.arange(n_extra)])

    out = {}
    for i, n_in in enumerate(nerf_layer_in_dims(cfg)):
        cols = torch.arange(n_in) if i == 0 else after_h(n_in - h)
        out[f"layers.{i}"] = (torch.arange(h), cols)
    out["sigma"] = (torch.arange(1), torch.arange(h))
    out["rgb_in"] = (torch.arange(rh), after_h(cfg.dir_dim))
    out["rgb"] = (torch.arange(3), torch.arange(rh))
    return out


@functools.lru_cache(maxsize=None)
def _template(cls, cfg):
    """A CPU module of class `cls` at `cfg`, whose tree pad_linears copies."""
    return cls(cfg, generator=torch.Generator())


def pad_linears(module: torch.nn.Module, cfg_p, idx: dict) -> torch.nn.Module:
    """A module of module's class at cfg_p whose Linear `name` of idx holds
    module's weight at (rows, cols) and its bias at rows, zeros elsewhere.
    Leading axes of module's parameters (stacked scenes, multiscene.py)
    carry over: every scene is padded alike."""
    tensors = {}
    with torch.no_grad():
        for name, (rows, cols) in idx.items():
            src, dst = module.get_submodule(name), _template(type(module), cfg_p).get_submodule(name)
            rows, cols = rows.to(src.weight.device), cols.to(src.weight.device)
            lead = src.weight.shape[:-2]
            w = src.weight.new_zeros(*lead, *dst.weight.shape)
            w[..., rows[:, None], cols[None, :]] = src.weight.detach()
            b = src.bias.new_zeros(*lead, *dst.bias.shape)
            b[..., rows] = src.bias.detach()
            tensors[f"{name}.weight"], tensors[f"{name}.bias"] = w, b
    return with_params(_template(type(module), cfg_p), tensors)


def unpad_linears(grads: List[torch.Tensor], idx: dict) -> List[torch.Tensor]:
    """Gradients of pad_linears' module (parameters() order: each Linear of
    idx, in idx's order, weight then bias) -> those of the original module:
    the padded entries dropped (leading scene axes kept)."""
    out, it = [], iter(grads)
    for rows, cols in idx.values():
        rows, cols = rows.to(grads[0].device), cols.to(grads[0].device)
        out.append(next(it)[..., rows[:, None], cols[None, :]])
        out.append(next(it)[..., rows])
    return out


def padded_cfg(cfg: NeRFConfig) -> NeRFConfig:
    """cfg at the widths the kernels launch: hidden and rgb_hidden rounded
    up to multiples of 8 (padded_widths)."""
    return dataclasses.replace(cfg, hidden=pad8(cfg.hidden), rgb_hidden=pad8(cfg.rgb_hidden))


def padded_widths(mlp: NeRFMLP, cfg: NeRFConfig):
    """-> (mlp, cfg) at hidden and rgb_hidden rounded up to multiples of 8,
    the widths the CUDA-core products take (kCols = 8, float4 loads): the
    new units' weights and biases are zero, so each padded unit is
    ReLU(0) = 0 and feeds the next layer through zero rows; the function
    and the real units' gradients do not change. The same objects when
    both widths are multiples of 8 already (every tensor-core width). A
    model of stacked scenes pads every scene alike."""
    cfg_p = padded_cfg(cfg)
    if cfg_p == cfg:
        return mlp, cfg
    check_mlp(mlp, cfg)
    return pad_linears(mlp, cfg_p, _pad_index(cfg, cfg_p)), cfg_p


def unpad_grads(grads: List[torch.Tensor], cfg: NeRFConfig, cfg_p: NeRFConfig):
    """Gradients of padded_widths' MLP (parameters() order) -> those of the
    original MLP: the padded entries dropped."""
    return grads if cfg_p == cfg else unpad_linears(grads, _pad_index(cfg, cfg_p))


def row_stride(cfg: NeRFConfig) -> int:
    """The row stride of the kernels' buffer X (csrc/nerf_mlp.cuh:
    row_stride): hidden + the wider encoding, at least rgb_hidden, odd."""
    e, dd = 3 + 6 * cfg.num_freqs, (3 + 6 * cfg.num_freqs_dir if cfg.use_viewdirs else 0)
    return max(cfg.hidden + max(e, dd), cfg.rgb_hidden) | 1


def spill_floats(cfg: NeRFConfig) -> int:
    """Floats of one block's slab of X on the spill route (csrc/nerf_mlp.cuh:
    spill_floats): 128 rows of row_stride, rounded up to 128 bytes."""
    return -(-TILE_POINTS * row_stride(cfg) // 32) * 32


def render_smem_bytes(cfg: NeRFConfig, tile_rays: int, seg: int, spill: bool = False) -> int:
    """Shared memory of a K3/K5 block in bytes (csrc/fused_nerf.cu:
    smem_bytes): X (unless spilled) and the points, a segment's heads, the
    rays' direction encodings."""
    dd = 3 + 6 * cfg.num_freqs_dir if cfg.use_viewdirs else 0
    x = 0 if spill else row_stride(cfg)
    return 4 * (TILE_POINTS * (x + 3) + tile_rays * seg * 4 + tile_rays * dd)


def walk_smem_bytes(cfg: NeRFConfig, tile_rays: int, n_samples: int, seg: int,
                    general: bool = False, spill: bool = False) -> int:
    """Shared memory of a K4/K6/K7 block in bytes (csrc/nerf_train_walk.cuh:
    walk_smem_bytes): X (unless spilled) and the points, 13 scalars a point
    of the segment (general: its points rounded up to whole 128-point
    chunks), 20 a ray, the direction encodings, each segment's entry
    transmittance."""
    dd = 3 + 6 * cfg.num_freqs_dir if cfg.use_viewdirs else 0
    n = tile_rays * seg
    if general:
        n = -(-n // TILE_POINTS) * TILE_POINTS
    x = 0 if spill else row_stride(cfg)
    return 4 * (TILE_POINTS * (x + 3) + WALK_POINT_SCALARS * n + WALK_RAY_SCALARS * tile_rays
                + tile_rays * dd + (n_samples // seg) * tile_rays)


@dataclasses.dataclass(frozen=True)
class NerfShape:
    """A K3-K7 launch's shape, by configuration (nerf_shape).

    tile_rays: rays a tile; threads: threads a block; rounds: rounds of the
    block's widest product (1: every item at once); general: the general
    kernel (products in rounds of whole point groups, a walk segment ending
    in a partial 128-point chunk), else the one-round kernel; spill: the
    general kernel's X in a device slab a block; smem_bytes: shared memory
    a block."""
    tile_rays: int
    threads: int
    rounds: int
    general: bool
    spill: bool
    smem_bytes: int

    @property
    def route(self) -> str:
        """'shared' (the one-round kernel), 'general' or 'spill'."""
        return "spill" if self.spill else ("general" if self.general else "shared")

    def fits(self, cfg: NeRFConfig) -> bool:
        """Whether a block of this shape launches at cfg's widths."""
        return (self.smem_bytes <= MAX_SMEM_BYTES
                and max(cfg.hidden, cfg.rgb_hidden) <= MAX_GENERAL_WIDTH)


ROUTES = ("shared", "general", "spill")


def nerf_shape(cfg: NeRFConfig, n_samples: int, seg: int, *, walk: bool = True,
               route: Optional[str] = None) -> NerfShape:
    """The shape of a K3-K7 launch by configuration, at cfg's launched
    widths (multiples of 8, padded_widths'): n_samples a ray in segments of
    `seg` (the walk of K4, K6, K7 with walk=True; the render of K3, K5, whose
    shared memory does not depend on n_samples, else).

    The one-round kernel ('shared') where it takes the shape, as before:
    block_threads <= 512 and, for the walk, the fewest rays that fill
    whole 128-point chunks (128 / gcd(128, seg)) within 227 KB; for the
    render, that tile capped at the threads and halved until it fits.
    Else the general kernel: at most 512 threads, the products in rounds,
    its tile that count capped at the threads and halved until the block
    fits 227 KB ('general'), or, where X alone passes 227 KB, with X in a
    device slab ('spill'). Every recipe keeps the one-round kernel. `route`
    forces one of ROUTES (to compare them; the C entry refuses a shape off
    its route). Never raises: a shape that fits no route (shared memory
    past 227 KB even spilled at one ray, widths past MAX_GENERAL_WIDTH) has
    fits() False."""
    if route is not None and route not in ROUTES:
        return nerf_shape(cfg, n_samples, seg, walk=walk)
    one = block_threads(cfg)
    gen = min(one, MAX_THREADS)
    tile0 = TILE_POINTS // math.gcd(TILE_POINTS, seg)

    def smem(tile, general, spill):
        if walk:
            return walk_smem_bytes(cfg, tile, n_samples, seg, general, spill)
        return render_smem_bytes(cfg, tile, seg, spill)

    def halve(tile, general, spill):
        while tile > 1 and smem(tile, general, spill) > MAX_SMEM_BYTES:
            tile //= 2
        return tile

    if route in (None, "shared"):
        tile = tile0 if walk else halve(min(tile0, one), False, False)
        if route == "shared" or (one <= MAX_THREADS and smem(tile, False, False) <= MAX_SMEM_BYTES):
            return NerfShape(tile, one, 1, False, False, smem(tile, False, False))
    spill = route == "spill"
    tile = halve(min(tile0, gen), True, spill)
    if route is None and smem(tile, True, False) > MAX_SMEM_BYTES:
        spill = True
        tile = halve(min(tile0, gen), True, True)
    if cfg.compute_dtype == torch.bfloat16 and mma_shapes_ok(cfg):
        rounds = 1 if gen // 32 >= 2 * (cfg.hidden // 32) else 2
    else:
        per = gen // max(1, max(cfg.hidden, cfg.rgb_hidden) // 8)
        rounds = -(-(TILE_POINTS // 8) // per) if per else 0
    return NerfShape(tile, gen, rounds, True, spill, smem(tile, True, spill))


def launch_shape(cfg: NeRFConfig, n_samples: int, seg: int, *, walk: bool,
                 route: Optional[str]) -> NerfShape:
    """nerf_shape for a launch: raises on a route not in ROUTES (or None)
    and on a shape that fits no route."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    shape = nerf_shape(cfg, n_samples, seg, walk=walk, route=route)
    if not shape.fits(cfg):
        raise ValueError(
            f"segments of {seg} samples ({shape.tile_rays} rays a tile) at hidden {cfg.hidden}, "
            f"rgb_hidden {cfg.rgb_hidden} need {shape.smem_bytes} B of shared memory even on "
            "the spill route: too large")
    return shape


def check_launch(mlp: NeRFMLP, cfg: NeRFConfig, rays_o, rays_d, z, seg: int,
                 route: Optional[str] = None) -> NerfShape:
    """Validate what the render kernel takes; returns its shape
    (nerf_shape, walk=False) for segments of `seg` samples."""
    check_inputs(mlp, cfg, rays_o, rays_d, z)
    return launch_shape(cfg, seg, seg, walk=False, route=route)


def general_blocks(shape: NerfShape, n_tiles: int, device) -> int:
    """Blocks of a launch: one a tile on the one-round render kernel; the
    general kernels walk the tiles on at most one block an SM."""
    if not shape.general:
        return n_tiles
    return min(n_tiles, torch.cuda.get_device_properties(device).multi_processor_count)


def spill_buffer(cfg: NeRFConfig, shape: NerfShape, n_slabs: int, device):
    """The spill route's X slabs (n_slabs of spill_floats), else None."""
    if not shape.spill:
        return None
    return torch.empty(n_slabs, spill_floats(cfg), dtype=torch.float32, device=device)


def pad_rays(rays_o, rays_d, pad: int):
    """Pad (..., R, 3) rays with `pad` rays of origin 0 and unit-z
    direction (finite norms) along R, contiguous."""
    lead = rays_o.shape[:-2]
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=rays_d.device)
    return (torch.cat([rays_o, rays_o.new_zeros(*lead, pad, 3)], dim=-2).contiguous(),
            torch.cat([rays_d, unit_z.expand(*lead, pad, 3)], dim=-2).contiguous())


@spanned
def fused_nerf_render_rays(
    mlp: NeRFMLP,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_vals: Optional[torch.Tensor] = None,
    *,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    return_weights: bool = False,
    route: Optional[str] = None,
):
    """One fused NeRF-MLP render pass -> comp_rgb (R, 3), plus the
    weights (R, S) when return_weights. z_vals (R, S) gives the depths;
    None uses the linspace of n_samples.

    CUDA tensors launch the kernel (or raise): on the tensor cores where
    render_uses_tensor_cores(cfg), else on the CUDA cores; in the shape of
    nerf_shape (`route` forces one of ROUTES, to compare them). CPU tensors
    take fused_nerf_render_rays_plain. `cfg` defaults to mlp.cfg."""
    cfg = cfg or mlp.cfg
    kw = dict(n_samples=n_samples, near=near, far=far, white_bkgd=white_bkgd, cfg=cfg,
              return_weights=return_weights)
    if rays_o.device.type == "cpu" and rays_d.device.type == "cpu":
        return fused_nerf_render_rays_plain(mlp, rays_o, rays_d, z_vals, **kw)
    S = z_vals.shape[1] if z_vals is not None else n_samples
    if S < 2:
        raise ValueError(f"the kernel needs at least 2 samples per ray, got {S}")
    given = mlp
    mlp, cfg = padded_widths(mlp, cfg)
    shape = check_launch(mlp, cfg, rays_o, rays_d, z_vals, S, route)
    tile = shape.tile_rays

    R = rays_o.shape[0]
    pad = -R % tile
    dev = rays_o.device
    o, d = pad_rays(rays_o, rays_d, pad)
    z = None
    if z_vals is not None:
        z = torch.cat([z_vals, z_vals.new_zeros(pad, S)]).contiguous()
    mma = render_uses_tensor_cores(cfg)
    with pack_span("fused_nerf_render_rays.pack", given):
        wts = pack_nerf_weights(mlp, cfg)
        w_mma = pack_mma_forward(mlp, cfg) if mma else None
    out = torch.empty(R + pad, 4, dtype=torch.float32, device=dev)
    w_out = torch.empty(R + pad, S, dtype=torch.float32, device=dev) if return_weights else None
    n_blocks = general_blocks(shape, (R + pad) // tile, dev)
    spill = spill_buffer(cfg, shape, n_blocks, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("fused_nerf_render_rays.launch"):
        err = _lib().tinynerf_fused_nerf(
            o.data_ptr(), d.data_ptr(), None if z is None else z.data_ptr(), wts.data_ptr(),
            None if w_mma is None else w_mma.data_ptr(), out.data_ptr(),
            None if w_out is None else w_out.data_ptr(),
            R + pad, tile, S, cfg.num_freqs, cfg.num_freqs_dir, int(cfg.use_viewdirs), cfg.hidden,
            cfg.depth, cfg.skip_at, cfg.rgb_hidden, float(near), float(far),
            int(cfg.compute_dtype == torch.bfloat16), int(shape.general),
            None if spill is None else spill.data_ptr(), n_blocks, dev.index, stream,
        )
    raise_on_error(err, "fused_nerf")
    fused_nerf_render_rays.launches += 1
    fused_nerf_render_rays.mma_launches += int(mma)
    fused_nerf_render_rays.general_launches += int(shape.general)
    fused_nerf_render_rays.spill_launches += int(shape.spill)
    comp = out[:R, :3]
    if white_bkgd:
        comp = comp + (1.0 - out[:R, 3:4])
    return (comp, w_out[:R]) if return_weights else comp


fused_nerf_render_rays.launches = 0  # kernel launches since the last reset
# ... of which took the tensor cores (every bf16 launch at mma_shapes_ok widths)
fused_nerf_render_rays.mma_launches = 0
# ... of which ran the general kernel (nerf_shape: past 512 threads or 227 KB)
fused_nerf_render_rays.general_launches = 0
# ... of which held X in device memory (the general kernel's spill route)
fused_nerf_render_rays.spill_launches = 0


def default_sample_block(s_union: int, cap: int) -> int:
    """The hierarchical pipeline's block, total: the JAX package's rule
    where it yields one, the largest divisor of the union that is <= cap
    and a multiple of 8 (or the union itself)
    (tinynerf_tpu/kernels/fused_nerf.py:332-337); else, where the JAX rule
    finds none (unions such as 100, 164 and 228), the largest divisor in
    [8, cap], a block that ends its tiles in partial 128-point chunks
    (K5 and the general walk take any block); else (no divisor in [8, cap]:
    a prime union, twice a prime) the union itself, one block. Never a
    block under 8 but the union itself; never raises."""
    divisors = [b for b in range(min(cap, s_union), 0, -1) if s_union % b == 0]
    jax_rule = [b for b in divisors if b % 8 == 0 or b == s_union]
    if jax_rule:
        return jax_rule[0]
    wide = [b for b in divisors if b >= 8]
    return wide[0] if wide else s_union


def union_depths(weights: torch.Tensor, n_fine: int, near: float, far: float) -> torch.Tensor:
    """The fine pass's depths: the coarse linspace and n_fine inverse-CDF
    samples of the coarse weights (R, n_coarse) over its interior bins,
    sorted -> (R, n_coarse + n_fine)."""
    R, n_coarse = weights.shape
    t = torch.linspace(0.0, 1.0, n_coarse, dtype=torch.float32, device=weights.device)
    z_c = (near * (1.0 - t) + far * t).expand(R, n_coarse)
    z_mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    z_f = sample_pdf(z_mids, weights[:, 1:-1], n_fine, randomized=False)
    return torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values


def fused_render_rays_hierarchical(
    params: NeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    *,
    n_coarse: int = 64,
    n_fine: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    white_bkgd: bool = True,
    cfg: Optional[NeRFConfig] = None,
    sample_block: Optional[int] = None,
):
    """Deterministic coarse -> resample -> fine pipeline ->
    (comp_coarse (R, 3), comp_fine (R, 3)); matches
    models/nerf.render_rays_hierarchical(randomized=False). Large unions
    (hidden * S_union > 128 * 384) or an explicit `sample_block` route
    the fine pass through the streamed K5."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        DEFAULT_SAMPLE_BLOCK,
        fused_nerf_render_rays_streamed,
    )

    cfg = cfg or params.cfg
    comp_c, weights = fused_nerf_render_rays(
        params.coarse, rays_o, rays_d, n_samples=n_coarse, near=near, far=far,
        white_bkgd=white_bkgd, cfg=cfg, return_weights=True,
    )
    z_union = union_depths(weights, n_fine, near, far)
    s_union = n_coarse + n_fine
    if sample_block is not None or cfg.hidden * s_union > STREAM_ABOVE:
        if sample_block is None:
            sample_block = default_sample_block(s_union, DEFAULT_SAMPLE_BLOCK)
        comp_f = fused_nerf_render_rays_streamed(
            params.fine, rays_o, rays_d, z_union, white_bkgd=white_bkgd, cfg=cfg,
            sample_block=sample_block,
        )
    else:
        comp_f = fused_nerf_render_rays(
            params.fine, rays_o, rays_d, z_union, near=near, far=far, white_bkgd=white_bkgd,
            cfg=cfg,
        )
    return comp_c, comp_f
