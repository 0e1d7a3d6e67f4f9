"""Checkpoint-driven model reconstruction for the render drivers.

Port of the TinyNeRF branch of tinynerf_tpu/utils/model_io.py:18-152:
rebuild the model from the checkpoint's stored cfg (with the
reference's defaults), load its parameters and build a matching image
renderer. The other model families are not ported yet.
"""

from __future__ import annotations

import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.render import make_image_renderer
from tinynerf_tpu_torch.utils import checkpoint as ckpt_lib


def load_model_and_renderer(
    ckpt_path: str,
    *,
    H: int,
    W: int,
    focal: float,
    n_samples: int = 64,
    near: float = 2.0,
    far: float = 6.0,
    chunk: int = 8192,
    fused: bool = True,
    frames: bool = False,
    device="cuda",
):
    """-> (model, renderer, meta); renderer is (model, pose) -> image, or
    with frames=True (model, poses (F,4,4)) -> (F,H,W,3)."""
    meta = ckpt_lib.read_meta(ckpt_path)["meta"]
    mcfg = meta.get("cfg", {"hidden": 128, "depth": 4, "skip_at": 2, "num_freqs": 10})
    model_kind = meta.get("model", "tinynerf")
    if model_kind != "tinynerf":
        raise NotImplementedError(
            f"model {model_kind!r} is not ported yet (ROADMAP.md, queue 1: "
            "'nerf' is item 9, 'grid' item 12)"
        )
    if mcfg.get("ndc", False):
        raise NotImplementedError("NDC checkpoints are not ported yet (ROADMAP.md, queue 1, item 10)")
    num_freqs = mcfg.get("num_freqs", 10)
    model_cfg = TinyNeRFConfig(
        in_dim=encoding_dim(num_freqs),
        hidden=mcfg["hidden"],
        depth=mcfg["depth"],
        skip_at=mcfg["skip_at"],
    )
    # The fixed-seed init is a template only: restore_params overwrites it.
    model = TinyNeRF(model_cfg, generator=torch.Generator().manual_seed(0), device=device)
    step, _ = ckpt_lib.restore_params(ckpt_path, model)
    renderer = make_image_renderer(
        H=H, W=W, focal=focal, chunk=chunk, n_samples=n_samples, near=near,
        far=far, num_freqs=num_freqs, model_cfg=model_cfg, use_fused=fused,
        frames=frames,
    )
    meta["step"] = step
    meta["model"] = model_kind
    return model, renderer, meta
