"""The hash-grid encoding's kernels (G): the forward and backward of
models/grid_nerf.py's encode_levels and encode_levels_bwd on a CUDA device.

They replace no TPU kernel: the JAX package runs the encoding in XLA by
design (tinynerf_tpu/models/grid_nerf.py). Both are C entry points of
csrc/grid_encode.cu (the design and its bound, bytes and L2 traffic, are
in its header):

- grid_encode_fwd(tables, u, cfg) -> features (N, n_levels * features):
  one launch that reads the tables in place (their pointers, passed by
  value) and keeps nothing for the backward but the points u;
- grid_encode_bwd(grad, u, cfg, sizes) -> each table's gradient, views of
  one (total entries, features) buffer: the corners' entries recomputed
  from u as 32-bit keys, CUB's stable radix sort on the key bits the entry
  count needs, each entry's run summed in the sorted order with every
  weight recomputed from the point's cell fractions. No float atomics:
  two runs give the same bits.

Both are bit-identical to the plain versions (grid_nerf.encode_levels_plain
and encode_levels_bwd_plain, and autograd's per-level gather) at two or
more features a level, and within float32 rounding of them at one, where
PyTorch sums in other orders. They
take any ladder GridNeRFConfig makes (levels, features, table sizes, the
dense/hashed mix) and raise where the tables laid end to end hold 2^31
entries or more (the keys are 32-bit), or a backward 2^31 corner terms or
more. A CPU tensor raises: the plain versions are grid_nerf's, which takes
them for CPU tensors only. Every buffer (the output, the backward's one
scratch buffer, whose size and sections the C library alone knows) is
allocated here with torch.empty, from the shapes, without waiting for the
device. `.launches` on each wrapper counts the kernel launches it made
(CUB's sort counted as one), and so does the counter grid_kernel_launches
(utils/profiling.count, while a profiler records), so that a run can show
the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from tinynerf_tpu_torch.utils.profiling import count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (first use) and load csrc/grid_encode.cu, typed for ctypes:
    every pointer and the stream as c_void_p."""
    from tinynerf_tpu_torch.kernels import _build

    lib = _build.load("grid_encode")
    i, p, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.tinynerf_grid_encode_fwd.argtypes = [p] * 5 + [i] * 4 + [p, i, p]
    lib.tinynerf_grid_encode_fwd.restype = i
    lib.tinynerf_grid_encode_bwd.argtypes = [p] * 5 + [i] * 4 + [p, p, ll, i, i, p]
    lib.tinynerf_grid_encode_bwd.restype = i
    lib.tinynerf_grid_bwd_scratch_bytes.argtypes = [i] * 6
    lib.tinynerf_grid_bwd_scratch_bytes.restype = ll
    lib.tinynerf_grid_launches.argtypes = [i] * 3
    lib.tinynerf_grid_launches.restype = i
    lib.tinynerf_cuda_error_string.argtypes = [i]
    lib.tinynerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tinynerf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=16)
def ladder(cfg) -> tuple:
    """(res, dense, sizes) as C int arrays, the total entry count and the
    key bits it needs, for cfg's levels; raises where the tables laid end
    to end hold 2^31 entries or more."""
    res, dense, sizes = cfg.level_resolutions(), cfg.level_is_dense(), cfg.level_table_sizes()
    total = sum(sizes)
    if total >= 1 << 31:
        raise ValueError(f"{total} entries in all: the grid kernels take fewer than 2^31 "
                         "(32-bit keys)")
    ints = ctypes.c_int * len(res)
    return (ints(*res), ints(*(int(d) for d in dense)), ints(*sizes), total,
            max(1, (total - 1).bit_length()))


@functools.lru_cache(maxsize=None)
def launches(n_levels: int, features: int, backward: bool) -> int:
    """Launches of one forward or one backward at this width (CUB's sort
    counted as one), as the C library counts them."""
    return _lib().tinynerf_grid_launches(n_levels, features, int(backward))


def _check_points(u: torch.Tensor) -> None:
    if u.device.type != "cuda" or u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 3:
        raise ValueError(f"u must be a float32 (N, 3) CUDA tensor, got {u.dtype} "
                         f"{tuple(u.shape)} on {u.device}")


def _counted(fn, n: int) -> None:
    fn.launches += n
    count("grid_kernel_launches", n)


def grid_encode_fwd(tables: Sequence[torch.Tensor], u: torch.Tensor, cfg) -> torch.Tensor:
    """Normalized points u (N, 3) in [0, 1] and the level tables (level
    order, each (T_l, features) float32 on u's device) -> features (N,
    n_levels * features), level-major within a row."""
    _check_points(u)
    res, dense, sizes, _, _ = ladder(cfg)
    L, F, N = cfg.n_levels, cfg.features, u.shape[0]
    if len(tables) != L:
        raise ValueError(f"{len(tables)} tables for {L} levels")
    align = 8 if F == 2 else 4  # F = 2 reads an entry as one float2
    for l, t in enumerate(tables):
        if (t.device != u.device or t.dtype != torch.float32 or tuple(t.shape) != (sizes[l], F)
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"table l{l} must be a contiguous float32 ({sizes[l]}, {F}) tensor "
                             f"on {u.device}, {align}-byte aligned")
    u = u.contiguous()
    out = torch.empty(N, L * F, dtype=torch.float32, device=u.device)
    ptrs = (ctypes.c_void_p * L)(*(t.data_ptr() for t in tables))
    err = _lib().tinynerf_grid_encode_fwd(
        u.data_ptr(), ptrs, res, dense, sizes, L, F, N, cfg.table_size, out.data_ptr(),
        u.device.index, torch.cuda.current_stream(u.device).cuda_stream)
    _raise_on(err, "grid_encode forward kernel")
    if N:
        _counted(grid_encode_fwd, launches(L, F, False))
    return out


grid_encode_fwd.launches = 0  # kernel launches since the last reset


@functools.lru_cache(maxsize=16)
def _scratch_bytes(n_levels: int, features: int, n_points: int, total: int, key_bits: int,
                   device: int) -> int:
    got = _lib().tinynerf_grid_bwd_scratch_bytes(n_levels, features, n_points, total, key_bits,
                                                 device)
    if got < 0:
        raise RuntimeError(f"the grid backward does not take {n_levels} levels x {n_points} "
                           f"points of {features} features over {total} entries")
    return got


def grid_encode_bwd(grad: torch.Tensor, u: torch.Tensor, cfg, sizes) -> List[torch.Tensor]:
    """The features' gradient (N, n_levels * features) and the forward's
    points u -> each table's gradient (sizes[l], features), every entry
    written: 0 where no corner fell."""
    _check_points(u)
    res, dense, csizes, total, key_bits = ladder(cfg)
    L, F, N = cfg.n_levels, cfg.features, u.shape[0]
    if list(sizes) != list(csizes):
        raise ValueError(f"table sizes {list(sizes)} do not match the ladder's {list(csizes)}")
    if grad.device != u.device or grad.dtype != torch.float32 or tuple(grad.shape) != (N, L * F):
        raise ValueError(f"grad must be float32 ({N}, {L * F}) on {u.device}")
    m = 8 * L * N
    if m >= 1 << 31:
        raise ValueError(f"{m} corner terms: the grid backward takes fewer than 2^31")
    dev = u.device
    u, grad = u.contiguous(), grad.contiguous()
    out = torch.empty(total, F, dtype=torch.float32, device=dev)
    if N == 0:
        return list(out.zero_().split(list(sizes)))
    nbytes = _scratch_bytes(L, F, N, total, key_bits, dev.index)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)  # the allocator aligns to 512
    err = _lib().tinynerf_grid_encode_bwd(
        u.data_ptr(), grad.data_ptr(), res, dense, csizes, L, F, N, cfg.table_size,
        out.data_ptr(), scratch.data_ptr(), nbytes, key_bits, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "grid_encode backward kernels")
    _counted(grid_encode_bwd, launches(L, F, True))
    return list(out.split(list(sizes)))


grid_encode_bwd.launches = 0  # kernel launches since the last reset (launches(.., True) a call)
