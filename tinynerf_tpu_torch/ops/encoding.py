"""Fourier positional encoding gamma(x).

Port of tinynerf_tpu/ops/encoding.py:19-42. Feature order is the
interleaved [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with
bands f_k = 2^k, k = 0..L-1; L=10 with include_input gives 63 dims.
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
