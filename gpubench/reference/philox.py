"""Philox4x32-10 and the stratified jitter of the port's training kernels,
in NumPy.

K2, K4 and K6 draw their stratified depths inside the kernel: for ray r
and sample s, curand's Philox4_32_10 state initialised with (seed,
subsequence=r, offset=s) gives one 32-bit word, whose low 24 bits are u
in [0, 1). curand_init with those arguments sets the counter to
(s // 4, 0, r, 0) and the key to (seed, 0), and curand() returns word
s % 4 of the block. The depth is the bin's lower edge plus (upper -
lower) * u on the grid near + s * h, h = (far - near) / (S - 1), the
first and last half-bins clamped, each operation rounded to float32.

This is a statement of what the kernels draw, written from curand's
definition; it reads nothing of the program.
"""

from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)
_SHIFT = np.uint64(32)


def philox4x32_10(ctr, key):
    """Ten rounds of Philox4x32 on counters ctr (4 arrays of uint32
    values) under key (2 arrays or ints) -> the 4 output words."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) & _MASK for c in ctr)
    k0, k1 = (np.asarray(k, dtype=np.uint64) & _MASK for k in key)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        p0 = _M0 * c0
        p1 = _M1 * c2
        hi0, lo0 = p0 >> _SHIFT, p0 & _MASK
        hi1, lo1 = p1 >> _SHIFT, p1 & _MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def curand_first_word(seed: int, subsequence: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """curand(&state) right after curand_init(seed, subsequence, offset,
    &state), for a 32-bit seed and subsequences below 2**32."""
    sub = np.asarray(subsequence, dtype=np.uint64)
    off = np.asarray(offset, dtype=np.uint64)
    sub, off = np.broadcast_arrays(sub, off)
    zero = np.zeros(sub.shape, dtype=np.uint64)
    words = philox4x32_10((off >> np.uint64(2), zero, sub, zero),
                          (np.uint64(seed) & _MASK, np.uint64(0)))
    pick = (off & np.uint64(3)).astype(np.int64)
    return np.choose(pick, words)


def jitter_depths(seed: int, n_rays: int, n_samples: int, near: float, far: float) -> np.ndarray:
    """(n_rays, n_samples) float32 depths that a training kernel draws for
    the int32 `seed` (rays numbered from 0 within a scene)."""
    f32 = np.float32
    h = f32((far - near) / (n_samples - 1))
    s = np.arange(n_samples, dtype=np.int64)
    grid = f32(near) + h * s.astype(f32)
    half = f32(0.5) * h
    lower = np.where(s == 0, grid, grid - half).astype(f32)
    upper = np.where(s == n_samples - 1, grid, grid + half).astype(f32)
    ray = np.arange(n_rays, dtype=np.uint64)[:, None]
    bits = curand_first_word(int(seed), ray, s.astype(np.uint64)[None, :])
    u = (bits & np.uint64(0xFFFFFF)).astype(f32) * f32(1.0 / 16777216.0)
    return (lower + (upper - lower) * u).astype(f32)
