"""Image/GIF writing for previews and novel-view renders.

Port of tinynerf_tpu/utils/image_io.py with the same artifacts (preview
PNGs, novel_views.gif at fps=15, loop=0). It writes through Pillow
instead of imageio, because the GPU machines this port targets ship
Pillow but not imageio.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def to_uint8(img) -> np.ndarray:
    """[0,1] float image -> uint8, matching (img * 255).astype(uint8).

    uint8 inputs pass through unchanged (renderers may quantize on the
    device to shrink the device->host copy 4x)."""
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr.astype(np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def write_png(path: str, img) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path, format="PNG")


def write_gif(path: str, frames: Sequence, fps: int = 15, loop: int = 0) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    images = [Image.fromarray(to_uint8(f)) for f in frames]
    # `duration` is per-frame milliseconds (fps=15 -> ~67ms).
    images[0].save(
        path, format="GIF", save_all=True, append_images=images[1:],
        duration=round(1000.0 / fps), loop=loop,
    )
