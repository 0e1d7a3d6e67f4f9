"""Density regularizers added outside the main loss path
(tinynerf_tpu/ops/regularizers.py:28-112).

The free-space sparsity prior: lam * mean(sigma(p)) over points drawn
uniformly in the scene box each step, an L1 prior on the density. The
squared error defends the surfaces the training rays see; most of the
box is empty, so the prior's expected gradient clears the diffuse
density the training rays rarely carve.

It is a gradient of its own, eager torch autograd of that term, added
into each parameter's .grad after the step's main gradient, whether
autograd or a fused kernel wrote that one (training.add_extra_grads;
after the mean-reduce in parallel/train.py), so the kernels need no
change. It costs n_points MLP evaluations (8192 by default) beside the
step's n_rand x S.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from tinynerf_tpu_torch.ops.encoding import positional_encoding


def make_sparsity_grad_fn(s, model_kind: str, *, nerf_cfg=None, lam: float,
                          n_points: int = 8192, aabb: Optional[torch.Tensor] = None):
    """-> fn(model, generator) -> gradients aligned to model.parameters()
    (None for a parameter the density does not reach).

    s: TrainSettings (num_freqs, model_cfg). model_kind: "tinynerf" |
    "nerf" (the prior applies to every MLP of the NeRF, coarse and fine,
    averaged; nerf_cfg required) | "grid" (nerf_cfg: the GridNeRFConfig;
    the prior reaches the tables through the gather's backward). aabb
    (2, 3) bounds the points (default: ops/occupancy.default_aabb). The
    points are drawn from `generator` on its device; fn.at_points(model,
    pts) gives the gradients at given points."""
    if aabb is None:
        from tinynerf_tpu_torch.ops.occupancy import default_aabb

        aabb = default_aabb()
    aabb = torch.as_tensor(aabb, dtype=torch.float32)

    if model_kind == "tinynerf":
        def mean_sigma(model, pts):
            x = positional_encoding(pts, num_freqs=s.num_freqs)
            _, sigma = model(x, s.model_cfg)
            return sigma.mean()

    elif model_kind == "nerf":
        if nerf_cfg is None:
            raise ValueError("model_kind='nerf' requires nerf_cfg")

        def mean_sigma(model, pts):
            x = positional_encoding(pts, num_freqs=nerf_cfg.num_freqs)
            d = None
            if nerf_cfg.use_viewdirs:
                # The density ignores the view direction: a constant one.
                unit = torch.ones(pts.shape[0], 3, device=pts.device)
                unit = unit / torch.sqrt(torch.tensor(3.0, device=pts.device))
                d = positional_encoding(unit, num_freqs=nerf_cfg.num_freqs_dir)
            mlps = dict(model.named_children())
            total = 0.0
            for name in sorted(mlps):
                _, sigma = mlps[name](x, d, nerf_cfg)
                total = total + sigma.mean()
            return total / len(mlps)

    elif model_kind == "grid":
        if nerf_cfg is None:
            raise ValueError("model_kind='grid' requires the GridNeRFConfig")

        def mean_sigma(model, pts):
            # The density ignores the view direction entirely.
            d = torch.zeros_like(pts)
            d[:, 2] = -1.0
            _, sigma = model(pts, d, nerf_cfg)
            return sigma.mean()

    else:
        raise ValueError(f"unknown model_kind={model_kind!r}")

    def grads_at(model, pts: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """The prior's gradients at the points pts (n, 3)."""
        with torch.enable_grad():
            value = lam * mean_sigma(model, pts)
            return list(torch.autograd.grad(value, list(model.parameters()), allow_unused=True))

    def grads_fn(model, generator: torch.Generator) -> List[Optional[torch.Tensor]]:
        box = aabb.to(next(model.parameters()).device)
        u = torch.rand((n_points, 3), generator=generator, dtype=torch.float32,
                       device=generator.device).to(box.device)
        return grads_at(model, box[0] + (box[1] - box[0]) * u)

    grads_fn.at_points = grads_at
    return grads_fn


def add_grads(model, extra: List[Optional[torch.Tensor]]) -> None:
    """Add `extra` (aligned to model.parameters(); None adds nothing) into
    each parameter's .grad."""
    for p, g in zip(model.parameters(), extra):
        if g is not None:
            p.grad = g if p.grad is None else p.grad + g
