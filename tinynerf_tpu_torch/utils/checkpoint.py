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

Multi-scene checkpoints (scenes=True; port of the JAX driver's batched
checkpoint, tinynerf_tpu/train_multiscene.py:165-171) hold a model of K
stacked scenes (multiscene.py): every leaf carries the leading K axis,
Adam's count (and the schedule's) included, as jax.vmap(opt.init) makes
them ((K,) int32); the tree strings are the single-scene ones.
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


def _to_jax(model: nn.Module, scenes: bool = False):
    """The model's parameters as a JAX-layout tree (TinyNeRF, NeRF or
    GridNeRF; with scenes, K stacked scenes: every leaf (K, ...))."""
    return _state_to_jax(model, model.state_dict(), scenes)


def _from_jax(model: nn.Module, tree, scenes: bool = False) -> Dict[str, torch.Tensor]:
    """A JAX-layout tree -> per-parameter tensors by name; with scenes,
    each leaf's leading K axis becomes each tensor's."""
    convert = _converters(model)[1]
    if not scenes:
        return convert(tree)
    leaves = _flatten(tree)
    states = [convert(_unflatten([x[k] for x in leaves], tree)) for k in range(len(leaves[0]))]
    return {n: torch.stack([st[n] for st in states]) for n in states[0]}


def _state_to_jax(model: nn.Module, state: Dict[str, torch.Tensor], scenes: bool = False):
    """Per-parameter tensors keyed by parameter name -> the JAX tree;
    with scenes, scene by scene, the leaves stacked on a leading K axis."""
    convert = _converters(model)[0]
    if not scenes:
        return convert(state)
    trees = [convert({n: v[k] for n, v in state.items()})
             for k in range(next(iter(state.values())).shape[0])]
    leaves = [np.stack(xs) for xs in zip(*(_flatten(t) for t in trees))]
    return _unflatten(leaves, trees[0])


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
    scenes: bool = False,
) -> None:
    """Atomically write params, the optimizer's state (optax's tree, see
    the module docstring), step and meta of a TinyNeRF, a NeRF or a
    GridNeRF, or with scenes of K stacked scenes (every leaf (K, ...), the
    counts (K,)). Before the first update the state is count 0 and zero
    moments."""
    named = dict(model.named_parameters())
    states = [optimizer.state.get(p, {}) for p in named.values()]
    count = np.asarray(int(states[0]["step"]) if states[0] else 0, dtype=np.int32)
    if scenes:
        count = np.full(next(iter(named.values())).shape[0], count, dtype=np.int32)
    mu, nu = {}, {}
    for (name, p), st in zip(named.items(), states):
        mu[name] = st["exp_avg"] if st else torch.zeros_like(p)
        nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(p)
    decay_steps, weight_decay, ema_decay = _options(optimizer)
    tree = _to_jax(model, scenes)
    opt_leaves = [count]
    opt_leaves += (_flatten(_state_to_jax(model, mu, scenes))
                   + _flatten(_state_to_jax(model, nu, scenes)))
    if decay_steps > 0:
        opt_leaves.append(count)  # the schedule counts the updates as Adam does
    if ema_decay > 0:
        opt_leaves += _flatten(_state_to_jax(model, dict(zip(named, optimizer.ema)), scenes))
    o_struct = optax_struct(tree_struct(tree), decay_steps, weight_decay, ema_decay)
    _write(path, _payload(model, opt_leaves, o_struct, step, meta, tree))


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


def restore_params(path: str, model: nn.Module,
                   scenes: bool = False) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint's parameters into `model` (TinyNeRF, NeRF or
    GridNeRF; with scenes, K stacked scenes from a multi-scene checkpoint)
    in place.

    Returns (step, meta). Raises ValueError when the stored structure or
    a leaf's shape does not match the model."""
    template = _to_jax(model, scenes)
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
    if scenes and any(x.shape[:1] != t.shape[:1] for x, t in zip(leaves, _flatten(template))):
        raise ValueError("checkpoint scene count does not match the model's")
    state = _from_jax(model, _unflatten(leaves, template), scenes)
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"checkpoint param {k} has shape {tuple(v.shape)} but the model "
                f"expects {tuple(want[k].shape)}: config/checkpoint mismatch"
            )
    model.load_state_dict(state)
    return step, info["meta"]


def restore_checkpoint(path: str, model: nn.Module, optimizer,
                       scenes: bool = False) -> Tuple[int, Dict[str, Any]]:
    """Load params and the optimizer's state into `model` and `optimizer`
    (a training.TrainOptimizer) in place; with scenes, K stacked scenes
    from a multi-scene checkpoint, whose scenes' counts must agree (one
    optimizer steps them in lockstep).

    Returns (step, meta). Raises ValueError when the stored optimizer
    state is not the tree of this optimizer's options for this model (a
    params-only checkpoint, another optimizer chain) or a shape does not
    match."""
    template = _to_jax(model, scenes)
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
    step, meta = restore_params(path, model, scenes)
    counts = np.unique(opt[0])
    if counts.size != 1:
        raise ValueError(f"the scenes' optimizer counts differ ({counts.tolist()}): one "
                         "optimizer steps every scene of the stack")
    count = int(counts[0])
    mu = _from_jax(model, _unflatten(opt[1:1 + n_p], template), scenes)
    nu = _from_jax(model, _unflatten(opt[1 + n_p:1 + 2 * n_p], template), scenes)
    optimizer.state.clear()
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device).reshape(p.shape).clone(),
            "exp_avg_sq": nu[name].to(p.device).reshape(p.shape).clone(),
        }
    if ema_decay > 0:
        ema = _from_jax(model, _unflatten(opt[n_opt - n_p:], template), scenes)
        optimizer.ema = [ema[name].to(p.device).reshape(p.shape).clone()
                         for name, p in model.named_parameters()]
    return step, meta


def latest_exists(path: str) -> bool:
    return os.path.exists(path)
