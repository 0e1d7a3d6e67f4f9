"""Import reference (PyTorch) TinyNeRF checkpoints.

Port of tinynerf_tpu/utils/torch_import.py:1-102. A user of the reference
has checkpoints shaped like src/train.py:143-148: {"model": state_dict,
"opt": ..., "step": N, "in_dim": 63, "cfg": {hidden, depth, skip_at}}
whose state_dict keys follow src/nerf.py's module tree:
    layers.{i}.weight / layers.{i}.bias        (torch Linear: (out, in))
    sigma.0.weight / sigma.0.bias
    rgb.0.weight / rgb.0.bias

The port's TinyNeRF (models/tinynerf.py) has exactly these names and
layouts, so a reference state_dict loads into it as it is:
params_from_torch_state_dict checks and copies the tensors, and
import_torch_checkpoint builds the TinyNeRF of the checkpoint's cfg and
loads them. params_to_torch_state_dict exports a port TinyNeRF to that
schema (numpy arrays; torch.save-able).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig


def _to_tensor(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(t, dtype=np.float32))


def params_from_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference state_dict (tensors or arrays) -> a state_dict for the
    port's TinyNeRF.load_state_dict (float32 CPU tensors, the same
    names). Raises ValueError when it is not a TinyNeRF state_dict."""
    out = {}
    i = 0
    while f"layers.{i}.weight" in state_dict:
        out[f"layers.{i}.weight"] = _to_tensor(state_dict[f"layers.{i}.weight"])
        out[f"layers.{i}.bias"] = _to_tensor(state_dict[f"layers.{i}.bias"])
        i += 1
    if not out:
        raise ValueError("no 'layers.N.weight' keys found — not a TinyNeRF state_dict")
    for head in ("sigma", "rgb"):
        for leaf in ("weight", "bias"):
            out[f"{head}.0.{leaf}"] = _to_tensor(state_dict[f"{head}.0.{leaf}"])
    return out


def params_to_torch_state_dict(model: TinyNeRF) -> Dict[str, np.ndarray]:
    """Inverse direction: a port TinyNeRF -> a reference-schema state_dict
    (numpy arrays; torch.save-able)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def import_torch_checkpoint(path: str, allow_pickle: bool = False, device="cuda",
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> Tuple[TinyNeRF, Dict[str, Any]]:
    """Load a reference .pth checkpoint -> (TinyNeRF on `device`, the card
    unless the caller asks for the CPU, meta).

    meta carries {"step", "in_dim", "cfg"} from the torch checkpoint
    (src/train.py:143-148 schema). Reference checkpoints are plain
    tensor/dict payloads, so torch.load(weights_only=True) suffices;
    arbitrary-pickle loading (which executes code from the file) is
    gated behind allow_pickle=True, as the JAX package's importer gates
    it. The model's compute dtype is `compute_dtype` (the port's default,
    bf16)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # what weights-only loading raises on other objects
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a weights-only torch checkpoint; pass "
                "allow_pickle=True to run the full (code-executing) unpickler "
                "if you trust the file"
            )
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["model"] if "model" in ckpt else ckpt
    params = params_from_torch_state_dict(state)
    meta = {
        "step": int(ckpt.get("step", 0)),
        "in_dim": int(ckpt.get("in_dim", params["layers.0.weight"].shape[1])),
        "cfg": dict(ckpt.get("cfg", {"hidden": 128, "depth": 4, "skip_at": 2})),
    }
    depth = sum(1 for k in params if k.startswith("layers.") and k.endswith(".weight"))
    cfg = TinyNeRFConfig(in_dim=meta["in_dim"], hidden=params["layers.0.weight"].shape[0],
                         depth=depth, skip_at=int(meta["cfg"].get("skip_at", 2)),
                         compute_dtype=compute_dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    return model.to(device), meta
