"""The TinyNeRF MLP as a torch module.

Port of tinynerf_tpu/models/tinynerf.py:31-103: a depth=4 Linear+ReLU
trunk of width 128; after the ReLU of layer (skip_at - 1) the encoded
input is concatenated (widths for the 63-dim encoding: 63->128,
128->128, 191->128, 128->128); heads sigma = Linear(128,1)+ReLU and
rgb = Linear(128,3)+Sigmoid. 66,308 parameters at the defaults.

Parameter names follow the reference's state_dict schema
(tinynerf_tpu/utils/torch_import.py:1-15): layers.{i}.weight/bias,
sigma.0.*, rgb.0.*. Weights are (out, in) as in nn.Linear; the JAX
package stores them (in, out), and params_from_jax / params_to_jax
convert between the two.

Matmul inputs are rounded to compute_dtype (bfloat16 by default) and
products accumulate in float32, the counterpart of XLA's bf16 dot with
preferred_element_type=f32. torch.matmul on bf16 tensors would round
its output to bf16, so the bf16 operands are widened back to f32
before the product: bf16 x bf16 products are exact in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class TinyNeRFConfig:
    in_dim: int = 63
    hidden: int = 128
    depth: int = 4
    skip_at: int = 2
    compute_dtype: torch.dtype = torch.bfloat16  # matmul input dtype; params stay f32


def layer_in_dims(cfg: TinyNeRFConfig) -> list:
    """Input width of each trunk layer (the layer after the skip sees
    hidden + in_dim inputs)."""
    dims, last = [], cfg.in_dim
    for i in range(cfg.depth):
        dims.append(last)
        last = cfg.hidden + cfg.in_dim if i == cfg.skip_at - 1 else cfg.hidden
    return dims


def dense(h: torch.Tensor, layer: nn.Linear, compute_dtype: torch.dtype) -> torch.Tensor:
    """Linear layer with compute_dtype inputs, accumulated in the
    parameters' own dtype (float32)."""
    acc = layer.weight.dtype
    x = h.to(compute_dtype).to(acc)
    w = layer.weight.to(compute_dtype).to(acc)
    return F.linear(x, w, layer.bias)


class TinyNeRF(nn.Module):
    """Encoded coords (N, in_dim) -> (rgb (N, 3), sigma (N, 1))."""

    def __init__(
        self,
        cfg: TinyNeRFConfig = TinyNeRFConfig(),
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden
        self.layers = nn.ModuleList(
            nn.Linear(n_in, hidden, device="meta") for n_in in layer_in_dims(cfg)
        )
        self.sigma = nn.Sequential(nn.Linear(hidden, 1, device="meta"))
        self.rgb = nn.Sequential(nn.Linear(hidden, 3, device="meta"))
        self.to_empty(device="cpu")
        self.reset_parameters(generator)
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and
        bias, drawn on the CPU from `generator` (the same numbers on
        every device)."""
        for lin in [*self.layers, self.sigma[0], self.rgb[0]]:
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator, dtype=torch.float32)
                p.copy_((u * 2.0 - 1.0) * bound)

    def forward(
        self,
        x: torch.Tensor,
        cfg: Optional[TinyNeRFConfig] = None,
        sigma_noise: Optional[torch.Tensor] = None,
    ):
        """Skip: concat [h, x] after the ReLU of layer (skip_at - 1).
        `cfg` overrides the module's own compute_dtype/skip_at.
        sigma_noise (N, 1) is train-time noise added to the raw density
        before the ReLU (tinynerf_tpu/models/tinynerf.py:75-98)."""
        cfg = cfg or self.cfg
        dt = cfg.compute_dtype
        h = x
        for i, layer in enumerate(self.layers):
            h = torch.relu(dense(h, layer, dt))
            if i == cfg.skip_at - 1:
                h = torch.cat([h, x.to(h.dtype)], dim=-1)
        rgb = torch.sigmoid(dense(h, self.rgb[0], dt))
        sigma_raw = dense(h, self.sigma[0], dt)
        if sigma_noise is not None:
            sigma_raw = sigma_raw + sigma_noise.to(sigma_raw.dtype)
        return rgb, torch.relu(sigma_raw)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX params tree ({"layers": [{"w", "b"}], "sigma", "rgb"}, w as
    (in, out)) -> a state_dict for TinyNeRF.load_state_dict."""

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    out = {}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.weight"] = t(layer["w"], transpose=True)
        out[f"layers.{i}.bias"] = t(layer["b"])
    for head in ("sigma", "rgb"):
        out[f"{head}.0.weight"] = t(tree[head]["w"], transpose=True)
        out[f"{head}.0.bias"] = t(tree[head]["b"])
    return out


def params_to_jax(model: nn.Module) -> Dict[str, Any]:
    """Inverse of params_from_jax: a JAX-layout tree of numpy arrays."""
    return state_to_jax(model.state_dict())


def state_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A TinyNeRF state_dict-shaped mapping (parameters, or per-parameter
    optimizer moments) -> a JAX-layout tree of numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state.items()}

    def lin(prefix):
        return {"b": sd[f"{prefix}.bias"].copy(), "w": sd[f"{prefix}.weight"].T.copy()}

    n_layers = sum(1 for k in sd if k.startswith("layers.") and k.endswith(".weight"))
    return {
        "layers": [lin(f"layers.{i}") for i in range(n_layers)],
        "rgb": lin("rgb.0"),
        "sigma": lin("sigma.0"),
    }
