"""Fourier positional encoding gamma(x), and the spherical-harmonics
direction encoding.

Port of tinynerf_tpu/ops/encoding.py:19-42. Feature order is the
interleaved [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
bands f_k = 2^k, k = 0..L-1; L=10 with include_input gives 63 dims.

sh_encoding projects unit directions onto the real spherical harmonics
of degree < 4 (16 components), Instant-NGP's direction encoding: the
standard real basis with the constants and signs of tiny-cuda-nn's
SphericalHarmonics encoding, l-major, m from -l to l.
"""

from __future__ import annotations

import torch


def encoding_dim(num_freqs: int = 10, include_input: bool = True, in_dim: int = 3) -> int:
    """Output feature dim: in_dim*2*L (+ in_dim if include_input)."""
    return in_dim * 2 * num_freqs + (in_dim if include_input else 0)


def positional_encoding(
    x: torch.Tensor, num_freqs: int = 10, include_input: bool = True
) -> torch.Tensor:
    """Encode (..., D) coords to (..., encoding_dim) Fourier features."""
    d = x.shape[-1]
    bands = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)  # (L,)
    scaled = x[..., None, :] * bands[:, None]  # (..., L, D)
    # (..., L, 2, D) flattens to [sin f0 (D), cos f0 (D), sin f1 (D), ...].
    sincos = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    feats = sincos.reshape(*x.shape[:-1], num_freqs * 2 * d)
    if include_input:
        feats = torch.cat([x, feats], dim=-1)
    return feats


SH_DIM = 16  # the real spherical harmonics of degree < 4


def sh_encoding(d: torch.Tensor) -> torch.Tensor:
    """Unit directions (..., 3) -> (..., 16) real spherical harmonics of
    degree 0-3, in float32."""
    x, y, z = d.float().unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (yy - 3.0 * xx),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (3.0 * yy - xx),
    ], dim=-1)
