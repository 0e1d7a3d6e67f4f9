"""Evaluation: PSNR and SSIM of rendered views against ground truth.

Port of tinynerf_tpu/evaluation.py:18-38.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from tinynerf_tpu_torch.utils.metrics import psnr, ssim


def evaluate_views(renderer, model, images, poses, indices: Sequence[int]) -> Dict[str, float]:
    """Render each pose in `indices`; PSNR + SSIM against ground truth.

    renderer: (model, pose) -> (H, W, 3) tensor; images (N, H, W, 3) and
    poses (N, 4, 4), numpy arrays or tensors.
    Returns {"psnr_mean", "psnr_min", "psnr_max", "ssim_mean",
    "per_view": [...]}.
    """
    scores, ssims = [], []
    for i in indices:
        img = renderer(model, poses[i])
        scores.append(float(psnr(img, images[i])))
        ssims.append(float(ssim(img, images[i])))
    return {
        "psnr_mean": float(np.mean(scores)),
        "psnr_min": float(np.min(scores)),
        "psnr_max": float(np.max(scores)),
        "ssim_mean": float(np.mean(ssims)),
        "per_view": [round(s, 3) for s in scores],
    }
