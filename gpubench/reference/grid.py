"""Plain PyTorch reference of Instant-NGP (Mueller, Evans, Schied and
Keller 2022, arXiv:2201.05989, sections 3, 4 and 5.4; instant-ngp's
configs/nerf/base.json): a multiresolution hash encoding (n_levels
levels of `features` features; resolutions on a geometric ladder from
base_res to max_res; a level whose (R + 1)^3 corners fit table_size is
dense, a finer one reads the spatial hash with primes 1, 2654435761 and
805459861 modulo table_size; each point blends its cell's 8 corners
trilinearly), a density MLP (one hidden layer) whose first output is
log-space density (sigma = exp), a colour MLP (two hidden layers, a
sigmoid) on all the density outputs and the view direction's 16 real
spherical harmonics (degree < 4), stratified samples, the photometric
MSE, and Adam with b2 0.99 and eps 1e-15 whose table entries with a zero
gradient are skipped (each entry's bias correction by its own count of
updates) and whose weight matrices take an L2 of l2_reg in the gradient.

Kept from the configuration's departures: a point is normalized by the
box of every training ray's [near, far] segment widened by aabb_margin of
its extent a side (not the unit cube), the ladder rounds, a dense level's
corner (x, y, z) is entry (x (R + 1) + y) (R + 1) + z, the MLPs have
biases. float32 sums, TF32 off, the products' operands in the
configuration's precision; prec="fp8" is the control. The one thing
followed from the program: its per-step generator stream, seeded (seed
<< 32) + step on the data's device, draws the pixel indices of image
step % N, then the stratified jitter.
"""

from __future__ import annotations

import torch

from gpubench.reference import common

PRIMES = (1, 2654435761, 805459861)
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792, 0.31539156525251999,
        0.54627421529603959, 0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)


def level_resolutions(cfg: dict) -> list:
    n, lo, hi = cfg["n_levels"], cfg["base_res"], cfg["max_res"]
    if n == 1:
        return [lo]
    g = (hi / lo) ** (1.0 / (n - 1))
    return [int(round(lo * g ** l)) for l in range(n)]


def table_sizes(cfg: dict) -> list:
    return [min((r + 1) ** 3, cfg["table_size"]) for r in level_resolutions(cfg)]


def layer_shapes(cfg: dict) -> dict:
    """{name: (out, in)} of the two MLPs' linears, in the program's order."""
    h, out = cfg["hidden"], cfg["density_outputs"]
    return {"geo0": (h, cfg["n_levels"] * cfg["features"]), "geo1": (out, h),
            "rgb0": (h, out + 16), "rgb1": (h, h), "rgb2": (3, h)}


def n_params(cfg: dict) -> int:
    return (sum(table_sizes(cfg)) * cfg["features"]
            + sum(o * i + o for o, i in layer_shapes(cfg).values()))


def init_weights(cfg: dict, generator: torch.Generator, device, n_scenes: int = 1) -> dict:
    """The tables uniform in +-1e-4 (the paper's initialization), then the
    MLPs as common.uniform_init draws them; one scene."""
    if n_scenes != 1:
        raise ValueError("the grid reference trains one scene")
    W = {}
    for l, t in enumerate(table_sizes(cfg)):
        u = torch.rand((t, cfg["features"]), generator=generator, dtype=torch.float32,
                       device=device)
        W[f"tables.l{l}"] = (u * 2.0 - 1.0) * 1e-4
    shapes, fan_in = {}, {}
    for name, (o, i) in layer_shapes(cfg).items():
        for kind, shape in (("weight", (o, i)), ("bias", (o,))):
            shapes[f"mlp.{name}.{kind}"] = shape
            fan_in[f"mlp.{name}.{kind}"] = i
    W.update(common.uniform_init(shapes, fan_in, generator, device))
    return W


def segment_box(ro: torch.Tensor, rd: torch.Tensor, near: float, far: float,
                margin: float) -> torch.Tensor:
    """(2, 3): the box of the rays' [near, far] segments (their ends),
    widened by `margin` of its extent on each side."""
    o, d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    ends = torch.cat([o + d * near, o + d * far])
    lo, hi = ends.min(dim=0).values, ends.max(dim=0).values
    return torch.stack([lo - margin * (hi - lo), hi + margin * (hi - lo)])


def sh(d: torch.Tensor) -> torch.Tensor:
    """Unit directions (N, 3) -> (N, 16): the real spherical harmonics
    Y_l^m, l = 0..3, m = -l..l, with the Condon-Shortley phase."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    c = SH_C
    return torch.stack([
        torch.full_like(x, c[0]),
        -c[1] * y, c[1] * z, -c[1] * x,
        c[2] * x * y, -c[2] * y * z, 3.0 * c[3] * z * z - c[3], -c[2] * x * z,
        c[4] * (x * x - y * y),
        c[5] * y * (y * y - 3.0 * x * x), c[6] * x * y * z, c[7] * y * (1.0 - 5.0 * z * z),
        c[8] * z * (5.0 * z * z - 3.0), c[7] * x * (1.0 - 5.0 * z * z),
        c[9] * z * (x * x - y * y), c[5] * x * (3.0 * y * y - x * x),
    ], dim=-1)


def encode(W: dict, pts: torch.Tensor, cfg: dict, box: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> the concatenated level features (N, L F)."""
    u = ((pts - box[0]) / (box[1] - box[0])).clamp(0.0, 1.0)
    T = cfg["table_size"]
    feats = []
    for l, res in enumerate(level_resolutions(cfg)):
        x = u * res
        cell = torch.floor(x).long().clamp(max=res - 1)
        frac = x - cell.float()
        table = W[f"tables.l{l}"]
        acc = 0.0
        for corner in range(8):
            bit = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                               device=pts.device)
            c = cell + bit
            wgt = torch.where(bit.bool(), frac, 1.0 - frac).prod(dim=-1)
            if (res + 1) ** 3 <= T:
                idx = (c[:, 0] * (res + 1) + c[:, 1]) * (res + 1) + c[:, 2]
            else:
                idx = (c[:, 0] * PRIMES[0] ^ c[:, 1] * PRIMES[1] ^ c[:, 2] * PRIMES[2]) % T
            acc = acc + wgt[:, None] * table[idx]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def field(W: dict, pts, dirs, cfg: dict, box, prec: str, raw: bool = False):
    """-> (rgb, sigma) at the points, or with raw=True the log density."""
    def lin(name, x):
        return common.linear(x, W[f"mlp.{name}.weight"], W[f"mlp.{name}.bias"], prec)

    geo = lin("geo1", torch.relu(lin("geo0", encode(W, pts, cfg, box))))
    if raw:
        return geo[:, 0]
    c = torch.relu(lin("rgb0", torch.cat([geo, sh(dirs)], dim=-1)))
    c = torch.relu(lin("rgb1", c))
    return torch.sigmoid(lin("rgb2", c)), torch.exp(geo[:, 0])


def box_of(ro, rd, cfg: dict):
    return segment_box(ro, rd, cfg["near"], cfg["far"], cfg["aabb_margin"])


@torch.no_grad()
def centre_density(W: dict, ro, rd, cfg: dict) -> None:
    """Shift the log density's bias, in place, so that its median at the
    grid samples of these rays is 0 (sigma 1): the tables start near 0, so
    the density is one seed-drawn constant otherwise (a view all matter or
    all background). The box is these rays' own: with tables near 0 the
    box barely moves the median."""
    z = common.linspace_depths(ro.shape[0], cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    W["mlp.geo1.bias"][0] -= field(W, pts, None, cfg, box_of(ro, rd, cfg), "float32",
                                   raw=True).median()


def one_pass(W: dict, ro, rd, z, cfg: dict, box, prec: str):
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    vd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    rgb, sigma = field(W, pts.reshape(-1, 3), vd.repeat_interleave(S, dim=0), cfg, box, prec)
    return common.composite(rgb.reshape(R, S, 3), sigma.reshape(R, S), z, rd, cfg["white_bkgd"])


def stratified(n_rays: int, cfg: dict, t_rand: torch.Tensor) -> torch.Tensor:
    """One depth a bin, the bins' edges at the midpoints of the evenly
    spaced depths in [near, far], at the fractions t_rand (R, S)."""
    z = common.linspace_depths(n_rays, cfg["n_samples"], cfg["near"], cfg["far"], t_rand.device)
    mids = 0.5 * (z[:, :-1] + z[:, 1:])
    lower = torch.cat([z[:, :1], mids], dim=-1)
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    return lower + (upper - lower) * t_rand


def render_rays(W: dict, ro, rd, cfg: dict, prec: str = "bfloat16", box=None):
    """Deterministic render (the evenly spaced depths) -> colour (R, 3);
    the box defaults to these rays' own."""
    z = common.linspace_depths(ro.shape[0], cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    return one_pass(W, ro, rd, z, cfg, box_of(ro, rd, cfg) if box is None else box, prec)[0]


def adam_step(params: dict, grads: dict, state: dict, cfg: dict) -> None:
    """One update in place: the weight matrices' gradients take l2_reg *
    w first; a table entry whose gradient is 0 keeps its value and moments
    and its own count; the rest is common.adam_step's Adam."""
    b1, b2, eps, lr = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["lr"]
    dense = {}
    for name, g in grads.items():
        if name.startswith("mlp.") and g.dim() == 2:
            g = g + cfg["l2_reg"] * params[name]
        if not name.startswith("tables."):
            dense[name] = g
            continue
        m = state.setdefault(("m", name), torch.zeros_like(g))
        v = state.setdefault(("v", name), torch.zeros_like(g))
        n = state.setdefault(("n", name), torch.zeros_like(g))
        hit = g != 0
        n[hit] += 1
        m[hit] = b1 * m[hit] + (1.0 - b1) * g[hit]
        v[hit] = b2 * v[hit] + (1.0 - b2) * g[hit] ** 2
        m_hat = m[hit] / (1.0 - b1 ** n[hit])
        v_hat = v[hit] / (1.0 - b2 ** n[hit])
        params[name][hit] -= lr * m_hat / (v_hat.sqrt() + eps)
    common.adam_step(params, dense, state, lr, b1=b1, b2=b2, eps=eps)


def train_steps(W0: dict, data: dict, cfg: dict, seed: int, steps: int, n_rand: int,
                prec: str = "bfloat16", fault: str = "") -> dict:
    """`steps` updates from W0 on image-mode batches of one scene (data:
    (1, N, H * W, 3)), the box of all its rays. -> {"losses": [[loss] per
    step], "grad1": {leaf: the first step's gradient as the optimizer
    takes it, L2 included}, "change": {leaf: after `steps` minus W0}}.
    fault: "half_batch" (the mean over the first half of the rays),
    "altered" (every loss gradient doubled)."""
    rays_o, rays_d, pixels = data["rays_o"][0], data["rays_d"][0], data["pixels"][0]
    dev = rays_o.device
    n_img, hw = rays_o.shape[:2]
    box = box_of(rays_o, rays_d, cfg)
    W = {k: v.clone() for k, v in W0.items()}
    state, losses, grad1 = {}, [], None
    for step in range(steps):
        gen = torch.Generator(device=dev).manual_seed((int(seed) << 32) + step)
        inds = torch.randint(0, hw, (n_rand,), generator=gen, device=dev)
        t_rand = torch.rand((n_rand, cfg["n_samples"]), generator=gen, dtype=torch.float32,
                            device=dev)
        if fault == "half_batch":
            inds, t_rand = inds[: n_rand // 2], t_rand[: n_rand // 2]
        img = step % n_img
        ro, rd, tgt = rays_o[img][inds], rays_d[img][inds], pixels[img][inds]
        params = {k: v.detach().requires_grad_(True) for k, v in W.items()}
        with torch.enable_grad():
            col, _ = one_pass(params, ro, rd, stratified(ro.shape[0], cfg, t_rand), cfg, box,
                              prec)
            loss = ((col - tgt) ** 2).mean()
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if fault == "altered":
            grads = {k: 2.0 * g for k, g in grads.items()}
        if grad1 is None:
            grad1 = {k: g + cfg["l2_reg"] * W[k] if k.startswith("mlp.") and g.dim() == 2
                     else g.clone() for k, g in grads.items()}
        adam_step(W, grads, state, cfg)
        losses.append([loss.item()])
    return {"losses": losses, "grad1": grad1, "change": {k: W[k] - W0[k] for k in W}}


def macs_per_point(cfg: dict) -> int:
    """The two MLPs' multiply-adds a point, forward."""
    return sum(o * i for o, i in layer_shapes(cfg).values())

