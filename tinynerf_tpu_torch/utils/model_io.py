"""Checkpoint-driven model reconstruction for the render drivers.

Port of tinynerf_tpu/utils/model_io.py:18-152 (TinyNeRF, NeRF with the
coarse or the occupancy proposal, the grid family): rebuild the model
from the checkpoint's stored cfg (with the reference's defaults), load
its parameters and build a matching image renderer. An NDC checkpoint
renders with reprojected rays over t in [0, 1]; an occupancy checkpoint
holds the fine MLP alone and rebuilds its sampler over the stored
occ_aabb; a grid checkpoint rebuilds its GridNeRFConfig from the meta's
`grid` entry (Instant-NGP's form fields where it names them), over the
box its tables were trained in, with the bf16
compute dtype (as the JAX loader), and renders with its encoding on its
own kernel and the rest in eager torch (`fused` does not apply).
"""

from __future__ import annotations

from typing import Optional

import torch

from tinynerf_tpu_torch.models.grid_nerf import FORM_FIELDS, GridNeRF, GridNeRFConfig
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.ops.occupancy import default_aabb
from tinynerf_tpu_torch.render import (
    make_grid_image_renderer,
    make_hierarchical_image_renderer,
    make_image_renderer,
    make_occupancy_image_renderer,
)
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
    n_fine: Optional[int] = None,
    aux: bool = False,
    device="cuda",
):
    """-> (model, renderer, meta); renderer is (model, pose) -> image, or
    with frames=True (model, poses (F,4,4)) -> (F,H,W,3); aux=True builds
    the geometry renderer (packed (depth, acc) pseudo-images,
    render.pack_aux).

    n_fine (None = the checkpoint's fine-sample count) overrides the
    full NeRF's fine-sample budget (for the occupancy proposal: its
    budget is n_samples + n_fine); an explicit 0 means zero fine
    samples. The NeRF renders in chunks of min(chunk, 4096) rays. An NDC
    checkpoint samples near 0, far 1 whatever near and far say."""
    meta = ckpt_lib.read_meta(ckpt_path)["meta"]
    mcfg = meta.get("cfg", {"hidden": 128, "depth": 4, "skip_at": 2, "num_freqs": 10})
    model_kind = meta.get("model", "tinynerf")
    # NDC training bakes the ray parameterization into the weights: the
    # renderer reprojects the same way and samples t in [0, 1].
    ndc = bool(mcfg.get("ndc", False))
    if ndc:
        near, far = 0.0, 1.0
    num_freqs = mcfg.get("num_freqs", 10)
    # The fixed-seed init is a template only: restore_params overwrites it.
    template = torch.Generator().manual_seed(0)
    if model_kind == "nerf":
        ncfg = NeRFConfig(
            num_freqs=num_freqs,
            num_freqs_dir=mcfg.get("num_freqs_dir", 4),
            hidden=mcfg["hidden"],
            depth=mcfg["depth"],
            skip_at=mcfg["skip_at"],
            rgb_hidden=mcfg.get("rgb_hidden", 64),
        )
        n_fine = n_fine if n_fine is not None else mcfg.get("n_fine", 64)
        if mcfg.get("proposal", "coarse") == "occupancy":
            # One MLP; the sampler (the density grid) is rebuilt from it in
            # the renderer over the box training stored.
            if mcfg.get("occ_aabb") is not None:
                aabb = torch.tensor(mcfg["occ_aabb"], dtype=torch.float32)
            else:
                aabb = default_aabb(1.0) if ndc else None
            model = NeRF(ncfg, generator=template, device=device, parts=("fine",))
            renderer = make_occupancy_image_renderer(
                H=H, W=W, focal=focal, chunk=min(chunk, 4096), n_samples=n_samples + n_fine,
                near=near, far=far, nerf_cfg=ncfg, use_fused=fused, frames=frames, ndc=ndc,
                aabb=aabb, aux=aux,
            )
        else:
            model = NeRF(ncfg, generator=template, device=device)
            renderer = make_hierarchical_image_renderer(
                H=H, W=W, focal=focal, chunk=min(chunk, 4096), n_coarse=n_samples,
                n_fine=n_fine, near=near, far=far, nerf_cfg=ncfg, use_fused=fused,
                frames=frames, ndc=ndc, aux=aux,
            )
    elif model_kind == "grid":
        g = mcfg.get("grid", {})
        gcfg = GridNeRFConfig(
            n_levels=g.get("levels", 8),
            features=g.get("features", 2),
            base_res=g.get("base_res", 16),
            max_res=g.get("max_res", 128),
            table_size=g.get("table_size", 1 << 17),
            hidden=g.get("hidden", 64),
            num_freqs_dir=mcfg.get("num_freqs_dir", 4),
            **{f: g[f] for f in FORM_FIELDS if f in g},
            # The box the tables were trained in: another box moves every
            # lookup into another cell.
            **({"aabb": tuple(float(v) for v in g["aabb"])} if g.get("aabb") is not None else {}),
        )
        model = GridNeRF(gcfg, generator=template, device=device)
        renderer = make_grid_image_renderer(
            H=H, W=W, focal=focal, grid_cfg=gcfg, chunk=chunk, n_samples=n_samples, near=near,
            far=far, frames=frames, ndc=ndc, aux=aux,
        )
    elif model_kind == "tinynerf":
        model_cfg = TinyNeRFConfig(
            in_dim=encoding_dim(num_freqs),
            hidden=mcfg["hidden"],
            depth=mcfg["depth"],
            skip_at=mcfg["skip_at"],
        )
        model = TinyNeRF(model_cfg, generator=template, device=device)
        renderer = make_image_renderer(
            H=H, W=W, focal=focal, chunk=chunk, n_samples=n_samples, near=near,
            far=far, num_freqs=num_freqs, model_cfg=model_cfg, use_fused=fused,
            frames=frames, ndc=ndc, aux=aux,
        )
    else:
        raise ValueError(f"unknown model {model_kind!r} in {ckpt_path} (tinynerf|nerf|grid)")
    step, _ = ckpt_lib.restore_params(ckpt_path, model)
    meta["step"] = step
    meta["model"] = model_kind
    return model, renderer, meta
