"""Read and write the JAX package's .npz checkpoints.

Port of tinynerf_tpu/utils/checkpoint.py:32-65, 114-147. A checkpoint
is one .npz holding every parameter leaf as `param_{i}` in JAX flatten
order, `step`, and a `meta` JSON blob with `param_struct` (the printed
tree structure), `n_params` and the caller's metadata. For TinyNeRF the
flatten order is
  layers[0].b, layers[0].w, ..., layers[D-1].w, rgb.b, rgb.w, sigma.b, sigma.w
with every w stored (in, out).

The port reads the parameters only (render consumers never need the
optimizer state) and writes params-only checkpoints that the JAX
package's restore_params accepts. Writes are atomic (temp file +
rename).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, params_from_jax, params_to_jax


def param_struct(depth: int) -> str:
    """The JAX treedef string of a TinyNeRF params tree of `depth` layers."""
    layers = ", ".join(["{'b': *, 'w': *}"] * depth)
    return (
        f"PyTreeDef({{'layers': [{layers}], 'rgb': {{'b': *, 'w': *}}, "
        "'sigma': {'b': *, 'w': *}})"
    )


def _flatten(tree) -> list:
    leaves = []
    for layer in tree["layers"]:
        leaves += [layer["b"], layer["w"]]
    for head in ("rgb", "sigma"):
        leaves += [tree[head]["b"], tree[head]["w"]]
    return leaves


def _unflatten(leaves: list, depth: int) -> Dict[str, Any]:
    def lin(i):
        return {"b": leaves[i], "w": leaves[i + 1]}

    return {
        "layers": [lin(2 * i) for i in range(depth)],
        "rgb": lin(2 * depth),
        "sigma": lin(2 * depth + 2),
    }


def save_params(path: str, model: TinyNeRF, step: int, meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write a params-only checkpoint (empty optimizer state)."""
    leaves = _flatten(params_to_jax(model))
    payload = {f"param_{i}": x for i, x in enumerate(leaves)}
    payload["step"] = np.asarray(step, dtype=np.int64)
    payload["meta"] = np.asarray(
        json.dumps(
            {
                "meta": meta or {},
                "param_struct": param_struct(len(model.layers)),
                "opt_struct": "PyTreeDef({})",
                "n_params": len(leaves),
                "n_opt": 0,
            }
        )
    )
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_meta(path: str) -> Dict[str, Any]:
    """The checkpoint's top-level meta JSON (param_struct, meta, ...)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def restore_params(path: str, model: TinyNeRF) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint's parameters into `model` in place.

    Returns (step, meta). Raises ValueError when the stored structure or
    a leaf's shape does not match the model."""
    depth = len(model.layers)
    want = model.state_dict()
    with np.load(path, allow_pickle=False) as z:
        info = json.loads(str(z["meta"]))
        if info["param_struct"] != param_struct(depth) or info["n_params"] != 2 * depth + 4:
            raise ValueError(
                "checkpoint param structure mismatch: "
                f"stored {info['param_struct']} vs model {param_struct(depth)}"
            )
        leaves = [np.asarray(z[f"param_{i}"]) for i in range(info["n_params"])]
        step = int(z["step"])
    state = params_from_jax(_unflatten(leaves, depth))
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"checkpoint param {k} has shape {tuple(v.shape)} but the model "
                f"expects {tuple(want[k].shape)}: config/checkpoint mismatch"
            )
    model.load_state_dict(state)
    return step, info["meta"]
