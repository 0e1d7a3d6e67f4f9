"""Plain PyTorch pieces of the NeRF equations that the references share.

Written from the NeRF paper (Mildenhall et al. 2020, section 4 and 5.2)
and the TinyNeRF reference recipe, in float32 with TF32 off. Nothing here
imports the program. `prec` names the products' precision: the
configuration's own ("bfloat16": every product's operands, forward and
backward, rounded to bf16, the sums in float32, as the port's models
define their products) for the reference, or "fp8" for the control (the
operands rounded to float8 e4m3 under a per-tensor scale to its range).
"""

from __future__ import annotations

import math

import torch

DELTA_INF = 1e10
TRANS_EPS = 1e-10
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


ROUND = {"bfloat16": bf16, "fp8": fp8}


class _RoundedLinear(torch.autograd.Function):
    """x @ w.T + b with every product's operands rounded (forward, and the
    upstream and weight-gradient products of the backward), summed in
    float32."""

    @staticmethod
    def forward(ctx, x, w, b, rnd):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.rnd = rnd
        return xq @ wq.t() + b

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.rnd(g)
        return gq @ wq, gq.t() @ xq, g.sum(0), None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """prec: "float32", "bfloat16" (the configurations' products) or "fp8"
    (the control)."""
    if prec == "float32":
        return x @ w.t() + b
    return _RoundedLinear.apply(x, w, b, ROUND[prec])


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """gamma(x) = [x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)],
    each sin and cos over the 3 coordinates."""
    feats = [x]
    for k in range(n_freqs):
        feats += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(feats, dim=-1)


def composite(rgb: torch.Tensor, sigma: torch.Tensor, z: torch.Tensor, rays_d: torch.Tensor,
              white_bkgd: bool = True):
    """The rendering equation's quadrature: rgb (R, S, 3), sigma (R, S),
    z (R, S) -> (colour (R, 3), weights (R, S))."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], DELTA_INF)], dim=-1)
    delta = delta * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + TRANS_EPS, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    colour = (w[..., None] * rgb).sum(dim=1)
    if white_bkgd:
        colour = colour + (1.0 - w.sum(dim=1, keepdim=True))
    return colour, w


def linspace_depths(n_rays: int, n_samples: int, near: float, far: float, device):
    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=device)
    return (near * (1.0 - t) + far * t).expand(n_rays, n_samples)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf that `weights`
    (R, B) put on the edges `bins` (R, B + 1), at the quantiles u (R, n),
    sorted per ray."""
    w = weights + eps
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (idx - 1).clamp(min=0)
    above = idx.clamp(max=weights.shape[1])
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = torch.where(c1 - c0 < 1e-8, torch.ones_like(c0), c1 - c0)
    return torch.sort(b0 + (u - c0) / denom * (b1 - b0), dim=-1).values


def pinhole_rays(size: int, focal: float, c2w: torch.Tensor):
    """Rays of a square pinhole camera looking along -z: origins and unit
    directions (size * size, 3), pixel (i, j) through
    ((i - W/2) / f, -(j - H/2) / f, -1)."""
    dev = c2w.device
    i = torch.arange(size, dtype=torch.float32, device=dev)[None, :].expand(size, size)
    j = torch.arange(size, dtype=torch.float32, device=dev)[:, None].expand(size, size)
    dirs = torch.stack([(i - size * 0.5) / focal, -(j - size * 0.5) / focal,
                        -torch.ones_like(i)], dim=-1).reshape(-1, 3)
    d = (dirs[:, None, :] * c2w[None, :3, :3]).sum(dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand(d.shape), d


def adam_step(params: dict, grads: dict, state: dict, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update in place (Kingma and Ba, algorithm 1; eps outside the
    square root of the bias-corrected second moment)."""
    state["t"] = t = state.get("t", 0) + 1
    for name, g in grads.items():
        m = state.setdefault(("m", name), torch.zeros_like(g))
        v = state.setdefault(("v", name), torch.zeros_like(g))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
        params[name].addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))


def uniform_init(shapes: dict, fan_in: dict, generator: torch.Generator, device,
                 n_scenes: int = 1) -> dict:
    """Every weight uniform in +-sqrt(6 / fan_in) (He's bound for ReLU
    layers, so that activations keep their scale through the trunk and
    every density head starts alive) and every bias in +-1/sqrt(fan_in),
    from one draw of the generator on `device`; (n_scenes, *shape) each
    when n_scenes > 1."""
    sizes = [math.prod(s) for s in shapes.values()]
    u = torch.rand(n_scenes * sum(sizes), generator=generator, dtype=torch.float32,
                   device=device).reshape(n_scenes, -1)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        bound = math.sqrt((6.0 if len(shape) == 2 else 1.0) / fan_in[name])
        t = (u[:, off:off + n] * 2.0 - 1.0) * bound
        out[name] = t.reshape(n_scenes, *shape) if n_scenes > 1 else t.reshape(shape)
        off += n
    return out


_MASK64 = (1 << 64) - 1


def scene_seed(seed: int, k: int) -> int:
    """Scene k's 31-bit seed: splitmix64 over (seed, k), the multi-scene
    trainer's convention for giving each scene a stream of its own."""
    h = 0
    for p in (seed, k):
        h = (h ^ (int(p) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h & 0x7FFFFFFF
