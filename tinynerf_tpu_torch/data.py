"""Dataset loading for tiny_nerf_data.npz, with the offline synthetic
fallback.

Port of tinynerf_tpu/data.py:32-38, 59-100. Schema: images (N,H,W,3)
float32 in [0,1], poses (N,4,4) camera-to-world, scalar focal (pixels);
float64 arrays are cast to float32. The port never downloads: a missing
dataset falls back to the cached, or freshly generated, procedural
scene of synthetic.py, which has the same schema.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

DEFAULT_DATA_PATH = "data/tiny_nerf_data.npz"
SYNTHETIC_DATA_PATH = "data/synthetic_tiny_nerf.npz"


def load_tiny_nerf_npz(path: str = DEFAULT_DATA_PATH) -> Dict[str, Any]:
    """Load the npz, normalizing float64 arrays to float32."""
    data = np.load(path)
    return {
        k: (v.astype(np.float32) if hasattr(v, "dtype") and v.dtype == np.float64 else v)
        for k, v in data.items()
    }


def ensure_data(
    path: str = DEFAULT_DATA_PATH,
    allow_synthetic: bool = True,
    synthetic_path: str = SYNTHETIC_DATA_PATH,
    device="cpu",
) -> Dict[str, Any]:
    """Return a dataset dict, preferring the real npz.

    Order: existing file at `path` -> cached synthetic -> freshly
    generated synthetic (rendered on `device`, cached to
    `synthetic_path`). The returned dict gains a bool key "synthetic".
    """
    if os.path.exists(path):
        d = load_tiny_nerf_npz(path)
        d["synthetic"] = False
        return d
    if not allow_synthetic:
        raise FileNotFoundError(f"{path} not found; pass allow_synthetic=True for the synthetic scene")
    print(
        f"[data] WARNING: {path} unavailable, falling back to the procedural "
        f"synthetic scene ({synthetic_path})",
        flush=True,
    )
    if os.path.exists(synthetic_path):
        d = load_tiny_nerf_npz(synthetic_path)
        d["synthetic"] = True
        return d
    from tinynerf_tpu_torch.synthetic import generate_synthetic_dataset

    d = generate_synthetic_dataset(device=device)
    os.makedirs(os.path.dirname(os.path.abspath(synthetic_path)), exist_ok=True)
    np.savez(synthetic_path, images=d["images"], poses=d["poses"], focal=d["focal"])
    d["synthetic"] = True
    return d
