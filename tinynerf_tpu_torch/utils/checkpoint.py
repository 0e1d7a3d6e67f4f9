"""Read and write the JAX package's .npz checkpoints.

Port of tinynerf_tpu/utils/checkpoint.py:32-65, 114-147. A checkpoint
is one .npz holding every parameter leaf as `param_{i}` in JAX flatten
order (dict keys sorted, lists in order), `step`, and a `meta` JSON blob
with `param_struct` (the printed tree structure), `n_params` and the
caller's metadata. Every w is stored (in, out). For TinyNeRF the flatten
order is
  layers[0].b, layers[0].w, ..., layers[D-1].w, rgb.b, rgb.w, sigma.b, sigma.w
and for the full NeRF ({'coarse', 'fine'}) each MLP in turn gives its
2 * depth + 6 leaves
  layers[0].b, ..., layers[D-1].w, rgb.b, rgb.w, rgb_in.b, rgb_in.w, sigma.b, sigma.w
and for the grid family ({'mlp', 'tables'})
  mlp.geo0.b, mlp.geo0.w, ..., mlp.rgb2.w, then the tables by their
  sorted names (l0, l1, l10, l11, ..., l2 past ten levels)

Training checkpoints (save_checkpoint / restore_checkpoint, port of
:32-111; TinyNeRF, NeRF or GridNeRF) also carry the optimizer's state in
the tree the JAX package's make_optimizer gives it (optax_struct), leaf
by leaf:
  opt_0                       Adam's count, an int32 scalar
  opt_1 .. opt_{n}            mu, in the params' flatten order, w as (in, out)
  opt_{n+1} .. opt_{2n}       nu, likewise
  opt_{2n+1}                  with lr_decay_steps: the schedule's count
  then n more                 with ema_decay: the EMA of the params, likewise
(AdamW's masked decay adds a node and no leaf). They map to the base
torch optimizer's per-parameter state "step", "exp_avg" and "exp_avg_sq"
and to training.TrainOptimizer's `ema` (weights transposed). A
checkpoint written by either package resumes in the other. Render
consumers read the parameters only (restore_params) and accept
params-only checkpoints (save_params) of every model family, the EMA
twin `<ckpt>.ema.npz` among them. save_checkpoint_rotating also keeps
the last few step-stamped copies. Writes are atomic (temp file +
rename).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch
from torch import nn

from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, grid_params_from_jax, grid_state_to_jax
from tinynerf_tpu_torch.models.nerf import NeRF, nerf_params_from_jax, nerf_state_to_jax
from tinynerf_tpu_torch.models.tinynerf import params_from_jax, state_to_jax


def _struct(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_struct(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_struct(x) for x in tree) + "]"
    return "*"


def tree_struct(tree) -> str:
    """The JAX treedef string of a tree of dicts, lists and leaves."""
    return f"PyTreeDef({_struct(tree)})"


def param_struct(depth: int) -> str:
    """The JAX treedef string of a TinyNeRF params tree of `depth` layers."""
    lin = {"b": None, "w": None}
    return tree_struct({"layers": [lin] * depth, "rgb": lin, "sigma": lin})


def opt_struct(depth: int) -> str:
    """The JAX treedef string of optax.adam's state for a TinyNeRF of
    `depth` layers."""
    return adam_struct(param_struct(depth))


def adam_struct(p_struct: str) -> str:
    """The JAX treedef string of optax.adam's state,
    (ScaleByAdamState(count, mu, nu), EmptyState()), for params of the
    treedef string `p_struct`."""
    return optax_struct(p_struct)


_EMPTY = "CustomNode(namedtuple[EmptyState], [])"


def optax_struct(p_struct: str, decay_steps: int = 0, weight_decay: float = 0.0,
                 ema_decay: float = 0.0) -> str:
    """The JAX treedef string of the state of the JAX package's
    make_optimizer (optax 0.2.6) for params of the treedef string
    `p_struct`: (ScaleByAdamState(count, mu, nu)[, MaskedState(EmptyState)
    with weight_decay], EmptyState, or ScaleByScheduleState(count) with
    decay_steps), and with ema_decay that tuple paired with
    EmaParamsState(ema)."""
    inner = p_struct[len("PyTreeDef("):-1]
    nodes = [f"CustomNode(namedtuple[ScaleByAdamState], [*, {inner}, {inner}])"]
    if weight_decay > 0:
        nodes.append(f"CustomNode(namedtuple[MaskedState], [{_EMPTY}])")
    nodes.append("CustomNode(namedtuple[ScaleByScheduleState], [*])" if decay_steps > 0
                 else _EMPTY)
    tree = "(" + ", ".join(nodes) + ")"
    if ema_decay > 0:
        tree = f"({tree}, CustomNode(namedtuple[EmaParamsState], [{inner}]))"
    return f"PyTreeDef({tree})"


def _options(optimizer):
    """The options of a training.TrainOptimizer that shape its state tree."""
    return optimizer.decay_steps, optimizer.weight_decay, optimizer.ema_decay


def _flatten(tree) -> list:
    """Leaves in JAX flatten order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flatten(t)]
    return [tree]


def _unflatten(leaves: list, template):
    """Inverse of _flatten: `leaves` into the structure of `template`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    return build(template)


def _converters(model: nn.Module):
    """(state -> JAX tree, JAX tree -> state_dict) of the model's family."""
    if isinstance(model, GridNeRF):
        return grid_state_to_jax, grid_params_from_jax
    if isinstance(model, NeRF):
        return nerf_state_to_jax, nerf_params_from_jax
    return state_to_jax, params_from_jax


def _to_jax(model: nn.Module):
    """The model's parameters as a JAX-layout tree (TinyNeRF, NeRF or GridNeRF)."""
    return _state_to_jax(model, model.state_dict())


def _from_jax(model: nn.Module, tree) -> Dict[str, torch.Tensor]:
    return _converters(model)[1](tree)


def _state_to_jax(model: nn.Module, state: Dict[str, torch.Tensor]):
    """Per-parameter tensors keyed by parameter name -> the JAX tree."""
    return _converters(model)[0](state)


def _write(path: str, payload: Dict[str, np.ndarray]) -> None:
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


def _payload(model: nn.Module, opt_leaves: list, o_struct: str, step: int, meta,
             tree=None) -> dict:
    tree = _to_jax(model) if tree is None else tree
    leaves = _flatten(tree)
    payload = {f"param_{i}": x for i, x in enumerate(leaves)}
    payload.update({f"opt_{i}": x for i, x in enumerate(opt_leaves)})
    payload["step"] = np.asarray(step, dtype=np.int64)
    payload["meta"] = np.asarray(
        json.dumps(
            {
                "meta": meta or {},
                "param_struct": tree_struct(tree),
                "opt_struct": o_struct,
                "n_params": len(leaves),
                "n_opt": len(opt_leaves),
            }
        )
    )
    return payload


def save_params(path: str, model: nn.Module, step: int, meta: Optional[Dict[str, Any]] = None,
                params: Optional[list] = None) -> None:
    """Atomically write a params-only checkpoint (empty optimizer state)
    of a TinyNeRF, a NeRF or a GridNeRF: the model's parameters, or
    `params` (tensors aligned to model.parameters(), e.g. the optimizer's
    EMA: the `<ckpt>.ema.npz` twin) in their place."""
    tree = None
    if params is not None:
        tree = _state_to_jax(model, dict(zip(dict(model.named_parameters()), params)))
    _write(path, _payload(model, [], "PyTreeDef({})", step, meta, tree))


def save_checkpoint(
    path: str,
    model: nn.Module,
    optimizer,
    step: int,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Atomically write params, the optimizer's state (optax's tree, see
    the module docstring), step and meta of a TinyNeRF, a NeRF or a
    GridNeRF. Before
    the first update the state is count 0 and zero moments."""
    named = dict(model.named_parameters())
    states = [optimizer.state.get(p, {}) for p in named.values()]
    count = np.asarray(int(states[0]["step"]) if states[0] else 0, dtype=np.int32)
    mu, nu = {}, {}
    for (name, p), st in zip(named.items(), states):
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    decay_steps, weight_decay, ema_decay = _options(optimizer)
    opt_leaves = [count]
    opt_leaves += _flatten(_state_to_jax(model, mu)) + _flatten(_state_to_jax(model, nu))
    if decay_steps > 0:
        opt_leaves.append(count)  # the schedule counts the updates as Adam does
    if ema_decay > 0:
        opt_leaves += _flatten(_state_to_jax(model, dict(zip(named, optimizer.ema))))
    o_struct = optax_struct(tree_struct(_to_jax(model)), decay_steps, weight_decay, ema_decay)
    _write(path, _payload(model, opt_leaves, o_struct, step, meta))


def save_checkpoint_rotating(path: str, model: nn.Module, optimizer, step: int,
                             meta: Optional[Dict[str, Any]] = None, keep: int = 3) -> None:
    """save_checkpoint, then a copy `<path>.step{N:08d}.npz`, pruning all
    but the last `keep` such copies (tinynerf_tpu/utils/checkpoint.py:154-180)."""
    save_checkpoint(path, model, optimizer, step, meta)
    base = os.path.abspath(path)
    shutil.copyfile(base, f"{base}.step{step:08d}.npz")
    prefix = os.path.basename(base) + ".step"
    dirname = os.path.dirname(base)
    history = sorted(f for f in os.listdir(dirname) if f.startswith(prefix) and f.endswith(".npz"))
    for old in history[:-keep]:
        os.unlink(os.path.join(dirname, old))


def read_meta(path: str) -> Dict[str, Any]:
    """The checkpoint's top-level meta JSON (param_struct, meta, ...)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def restore_params(path: str, model: nn.Module) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint's parameters into `model` (TinyNeRF, NeRF or
    GridNeRF) in place.

    Returns (step, meta). Raises ValueError when the stored structure or
    a leaf's shape does not match the model."""
    template = _to_jax(model)
    struct, n_params = tree_struct(template), len(_flatten(template))
    want = model.state_dict()
    with np.load(path, allow_pickle=False) as z:
        info = json.loads(str(z["meta"]))
        if info["param_struct"] != struct or info["n_params"] != n_params:
            raise ValueError(
                "checkpoint param structure mismatch: "
                f"stored {info['param_struct']} vs model {struct}"
            )
        leaves = [np.asarray(z[f"param_{i}"]) for i in range(n_params)]
        step = int(z["step"])
    state = _from_jax(model, _unflatten(leaves, template))
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"checkpoint param {k} has shape {tuple(v.shape)} but the model "
                f"expects {tuple(want[k].shape)}: config/checkpoint mismatch"
            )
    model.load_state_dict(state)
    return step, info["meta"]


def restore_checkpoint(path: str, model: nn.Module, optimizer) -> Tuple[int, Dict[str, Any]]:
    """Load params and the optimizer's state into `model` and `optimizer`
    (a training.TrainOptimizer) in place.

    Returns (step, meta). Raises ValueError when the stored optimizer
    state is not the tree of this optimizer's options for this model (a
    params-only checkpoint, another optimizer chain) or a shape does not
    match."""
    template = _to_jax(model)
    decay_steps, weight_decay, ema_decay = _options(optimizer)
    want = optax_struct(tree_struct(template), decay_steps, weight_decay, ema_decay)
    with np.load(path, allow_pickle=False) as z:
        info = json.loads(str(z["meta"]))
        n_p = info["n_params"]
        n_opt = 1 + 2 * n_p + int(decay_steps > 0) + (n_p if ema_decay > 0 else 0)
        if info["opt_struct"] != want or info["n_opt"] != n_opt:
            raise ValueError(
                "checkpoint optimizer-state structure mismatch: "
                f"stored {info['opt_struct']} vs this optimizer's {want}"
            )
        opt = [np.asarray(z[f"opt_{i}"]) for i in range(info["n_opt"])]
    step, meta = restore_params(path, model)
    count = int(opt[0])
    mu = _from_jax(model, _unflatten(opt[1:1 + n_p], template))
    nu = _from_jax(model, _unflatten(opt[1 + n_p:1 + 2 * n_p], template))
    optimizer.state.clear()
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).clone(),
        }
    if ema_decay > 0:
        ema = _from_jax(model, _unflatten(opt[n_opt - n_p:], template))
        optimizer.ema = [ema[name].to(p.device).reshape(p.shape).clone()
                         for name, p in model.named_parameters()]
    return step, meta


def latest_exists(path: str) -> bool:
    return os.path.exists(path)
