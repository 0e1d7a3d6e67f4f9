"""The work a call needs, counted from the configuration and the shapes,
whatever implements it, and the card's published peaks.

Multiply-adds per point: the forward is every linear layer's in x out.
Training counts the forward and the weight-gradient products in full and
the upstream (input-gradient) products only where a layer's input comes
from another layer: none for the first layer (the encoding), and only the
first `hidden` rows of a wider input (the skip layer's [h, enc], the view
branch's [h, dir_enc]). A recomputed forward, padding and idle threads are
not counted. Bytes: each input read once, each output written once, in
float32.
"""

from __future__ import annotations

# One NVIDIA H100 SXM at 700 W, NVIDIA's data sheet, dense.
PEAK_FLOPS = 989e12  # bf16 on the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def forward_macs(shapes: dict) -> int:
    """shapes: {layer: (out, in)} of one MLP."""
    return sum(o * i for o, i in shapes.values())


def train_macs(shapes: dict, hidden: int) -> int:
    layers = list(shapes.values())
    upstream = sum(o * min(i, hidden) for o, i in layers[1:])
    return 2 * forward_macs(shapes) + upstream


def n_params(shapes: dict) -> int:
    return sum(o * i + o for o, i in shapes.values())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the bf16 peak
    or bytes over the memory rate, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def render_pass(shapes: dict, rays: int, samples: int, weights_out: bool) -> tuple:
    """(FLOPs, bytes) of one deterministic render pass (K1, K3): rays in,
    depths in past the first pass, parameters in, colours (and the
    per-sample weights) out."""
    flops = 2 * rays * samples * forward_macs(shapes)
    nbytes = 4 * (rays * (6 + 3) + n_params(shapes) + rays * samples * int(weights_out))
    return flops, nbytes


def train_pass(shapes: dict, hidden: int, rays: int, samples: int, depths_in: bool,
               sampling_out: bool) -> tuple:
    """(FLOPs, bytes) of one training pass (K2, K4, K6): rays and targets
    in, parameters in, gradients and the loss out, the given depths in or
    the drawn depths and weights out."""
    flops = 2 * rays * samples * train_macs(shapes, hidden)
    nbytes = 4 * (rays * 9 + 2 * n_params(shapes) + 1 + rays * samples * int(depths_in)
                  + 2 * rays * samples * int(sampling_out))
    return flops, nbytes


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)

