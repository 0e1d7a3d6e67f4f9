"""Image-quality metrics.

Port of tinynerf_tpu/utils/metrics.py:15-70: PSNR = -10 log10(max(mse,
1e-10)), and SSIM with an 11-tap Gaussian window (sigma 1.5),
edge-replicate padding and the window//2 border cropped before the mean.
"""

from __future__ import annotations

import torch


def mse2psnr(mse) -> torch.Tensor:
    """Convert MSE to PSNR in dB, clamped below at 1e-10."""
    mse = torch.clamp(torch.as_tensor(mse, dtype=torch.float32), min=1e-10)
    return -10.0 * torch.log10(mse)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR between two images/arrays in [0, 1]."""
    target = torch.as_tensor(target, device=pred.device)
    return mse2psnr(torch.mean((pred.float() - target.float()) ** 2))


def _blur(img: torch.Tensor, g: torch.Tensor, dim: int) -> torch.Tensor:
    """Correlate along `dim` with the window g, edge-replicate padded."""
    n, half = img.shape[dim], g.numel() // 2
    idx = torch.clamp(torch.arange(-half, n + half, device=img.device), 0, n - 1)
    x = img.index_select(dim, idx)
    return sum(g[i] * x.narrow(dim, i, n) for i in range(g.numel()))


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    window: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity for (H, W, C) images in [0, 1]."""
    pred = pred.float()
    target = torch.as_tensor(target, device=pred.device).float()
    half = window // 2
    coords = torch.arange(window, dtype=torch.float32, device=pred.device) - half
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)

    def blur(img):  # separable Gaussian over H, then W
        return _blur(_blur(img, g, 0), g, 1)

    mu_p, mu_t = blur(pred), blur(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sig_p = blur(pred * pred) - mu_pp
    sig_t = blur(target * target) - mu_tt
    sig_pt = blur(pred * target) - mu_pt
    c1, c2 = k1**2, k2**2
    num = (2 * mu_pt + c1) * (2 * sig_pt + c2)
    den = (mu_pp + mu_tt + c1) * (sig_p + sig_t + c2)
    ssim_map = num / den
    return torch.mean(ssim_map[half:-half, half:-half])
