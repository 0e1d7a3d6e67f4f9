"""Models of stacked scenes: K models of one architecture held as one
module whose parameters carry a leading scene axis.

The JAX package stacks K parameter pytrees with jax.vmap
(tinynerf_tpu/multiscene.py:31-41). Here stack_models turns K modules
(TinyNeRF or NeRF) into one module of the same class and the same
parameter names, each parameter (K, *shape): torch.func.stack_module_state
stacks them, and the module tree is the first model's, its parameters
replaced. Its nn.Linear layers keep their in_features/out_features, so
the kernels' wrappers read the widths as from one model; its forward is
not called (a 3-D weight is no nn.Linear weight): scene_module gives one
scene's ordinary module, and functional_call runs a scene on slices.
"""

from __future__ import annotations

import copy
from typing import Dict, Sequence

import torch
from torch import nn


def with_params(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """A copy of `module` whose parameters (by name) are new leaves holding
    `tensors`; nothing else of the old parameters is copied."""
    named = dict(module.named_parameters())
    memo = {id(named[n]): nn.Parameter(t, requires_grad=named[n].requires_grad)
            for n, t in tensors.items()}
    return copy.deepcopy(module, memo)


def stack_models(models: Sequence[nn.Module]) -> nn.Module:
    """One module of K stacked scenes from K models of one architecture:
    the first model's class and tree, every parameter (K, *shape) in the
    models' order."""
    params, _ = torch.func.stack_module_state(list(models))
    return with_params(models[0], {n: t.detach().clone() for n, t in params.items()})


@torch.no_grad()
def scene_module(model: nn.Module, k: int) -> nn.Module:
    """Scene k of a stacked model as an ordinary single-scene module (a
    copy of its weights)."""
    return with_params(model, {n: p[k].clone() for n, p in model.named_parameters()})


def scene_state(model: nn.Module, k: int) -> Dict[str, torch.Tensor]:
    """Scene k's parameters by name, as views of the stacked leaves (their
    gradients flow into the stack): for torch.func.functional_call."""
    return {n: p[k] for n, p in model.named_parameters()}


def per_scene(fn, model: nn.Module, args: Sequence, scene_kw: Dict, **kw):
    """A one-scene function fn(module, *args, **scene_kw, **kw) -> (loss,
    grads, *more) run on each scene k in turn, on scene_module(model, k)
    and the k-th entry of every argument in `args` and `scene_kw` that is
    not None (`kw` is passed as it is) -> (loss (K,), grads, *more), every
    tensor stacked on a leading scene axis. The batched kernels' plain
    versions."""

    def at(x, k):
        return None if x is None else x[k]

    results = [fn(scene_module(model, k), *(at(a, k) for a in args),
                  **{n: at(v, k) for n, v in scene_kw.items()}, **kw)
               for k in range(len(args[0]))]
    grads = [torch.stack(gs) for gs in zip(*(r[1] for r in results))]
    more = [torch.stack(xs) for xs in zip(*(r[2:] for r in results))]
    return (torch.stack([r[0] for r in results]), grads, *more)
