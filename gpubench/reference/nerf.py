"""Plain PyTorch reference of the NeRF paper's model (Mildenhall et al.
2020, arXiv:2003.08934, section 5.3, appendix A): coarse and fine MLPs,
each a depth x hidden ReLU trunk that takes the encoded position again
after layer skip_at, a density head on the trunk and a view branch of
rgb_hidden units on [trunk, encoded direction]; hierarchical sampling;
the summed coarse and fine photometric loss; Adam.

Departure kept from the program's configuration: the density and the
view branch read the trunk's output directly (no extra 256-wide feature
layer). float32 sums, TF32 off, the products' operands in the configuration's
precision; prec="fp8" is the control.
"""

from __future__ import annotations

import torch

from gpubench.reference import common
from gpubench.reference.philox import jitter_depths

PARTS = ("coarse", "fine")


def enc_dim(n_freqs: int) -> int:
    return 3 + 6 * n_freqs


def layer_shapes(cfg: dict) -> dict:
    """{name: (out, in)} of one MLP's linears, in the program's order."""
    h, e, d = cfg["hidden"], enc_dim(cfg["num_freqs"]), enc_dim(cfg["num_freqs_dir"])
    shapes, last = {}, e
    for i in range(cfg["depth"]):
        shapes[f"layers.{i}"] = (h, last)
        last = h + e if i == cfg["skip_at"] - 1 else h
    shapes["sigma"] = (1, h)
    shapes["rgb_in"] = (cfg["rgb_hidden"], h + d)
    shapes["rgb"] = (3, cfg["rgb_hidden"])
    return shapes


def init_weights(cfg: dict, generator: torch.Generator, device, n_scenes: int = 1) -> dict:
    """Both MLPs' parameters, named '<part>.<layer>.weight' / '.bias'."""
    shapes, fan_in = {}, {}
    for part in PARTS:
        for name, (o, i) in layer_shapes(cfg).items():
            for kind, shape in (("weight", (o, i)), ("bias", (o,))):
                shapes[f"{part}.{name}.{kind}"] = shape
                fan_in[f"{part}.{name}.{kind}"] = i
    return common.uniform_init(shapes, fan_in, generator, device, n_scenes)


def _lin(W: dict, part: str, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    return common.linear(x, W[f"{part}.{name}.weight"], W[f"{part}.{name}.bias"], prec)


def trunk(W: dict, part: str, x_enc: torch.Tensor, cfg: dict, prec: str):
    """-> (the trunk's output, the raw (pre-ReLU) density)."""
    h = x_enc
    for i in range(cfg["depth"]):
        h = torch.relu(_lin(W, part, f"layers.{i}", h, prec))
        if i == cfg["skip_at"] - 1:
            h = torch.cat([h, x_enc], dim=-1)
    return h, _lin(W, part, "sigma", h, prec)[:, 0]


def mlp(W: dict, part: str, x_enc: torch.Tensor, d_enc: torch.Tensor, cfg: dict, prec: str):
    h, sigma_raw = trunk(W, part, x_enc, cfg, prec)
    h = torch.relu(_lin(W, part, "rgb_in", torch.cat([h, d_enc], dim=-1), prec))
    return torch.sigmoid(_lin(W, part, "rgb", h, prec)), torch.relu(sigma_raw)


@torch.no_grad()
def centre_density(W: dict, ro, rd, cfg: dict) -> None:
    """Shift each MLP's density bias, in place, so that the median raw
    density at the grid samples of these rays is 0. A random trunk's
    density is otherwise dense or empty nearly everywhere, by the seed;
    centred, half of the space holds matter on every seed. ro, rd (R, 3)
    for one pair of MLPs, (K, R, 3) for K stacked scenes."""
    if ro.dim() == 3:
        for k in range(ro.shape[0]):
            centre_density({n: v[k] for n, v in W.items()}, ro[k], rd[k], cfg)
        return
    z = common.linspace_depths(ro.shape[0], cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    x_enc = common.encode((ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3),
                          cfg["num_freqs"])
    for part in PARTS:
        W[f"{part}.sigma.bias"] -= trunk(W, part, x_enc, cfg, "float32")[1].median()


def one_pass(W: dict, part: str, ro, rd, z, cfg: dict, prec: str):
    """One MLP over the depths z (R, S) of the rays -> (colour, weights)."""
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x_enc = common.encode(pts.reshape(-1, 3), cfg["num_freqs"])
    vd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    d_enc = common.encode(vd, cfg["num_freqs_dir"]).repeat_interleave(S, dim=0)
    rgb, sigma = mlp(W, part, x_enc, d_enc, cfg, prec)
    return common.composite(rgb.reshape(R, S, 3), sigma.reshape(R, S), z, rd, cfg["white_bkgd"])


def render_rays(W: dict, ro, rd, cfg: dict, prec: str = "bfloat16"):
    """Deterministic hierarchical render of rays -> fine colour (R, 3)."""
    R = ro.shape[0]
    z_c = common.linspace_depths(R, cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    _, w_c = one_pass(W, "coarse", ro, rd, z_c, cfg, prec)
    u = torch.linspace(0.0, 1.0, cfg["n_fine"], dtype=torch.float32, device=ro.device)
    z_f = common.sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_c[:, 1:-1], cfg["n_fine"],
                            u.expand(R, -1))
    z = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    return one_pass(W, "fine", ro, rd, z, cfg, prec)[0]


def step_loss(W: dict, ro, rd, target, kernel_seed: int, u_fine_fn, cfg: dict, prec: str):
    """The training loss of one ray batch: coarse depths jittered as the
    kernels jitter them (kernel_seed), the fine depths from the coarse
    weights at the quantiles u_fine_fn() draws -> (mse_coarse, mse_fine)."""
    R = ro.shape[0]
    z_c = torch.from_numpy(jitter_depths(kernel_seed, R, cfg["n_samples"], cfg["near"],
                                         cfg["far"])).to(ro.device)
    col_c, w_c = one_pass(W, "coarse", ro, rd, z_c, cfg, prec)
    z_f = common.sample_pdf(0.5 * (z_c[:, 1:] + z_c[:, :-1]), w_c[:, 1:-1].detach(),
                            cfg["n_fine"], u_fine_fn())
    z = torch.sort(torch.cat([z_c, z_f], dim=-1), dim=-1).values
    col_f, _ = one_pass(W, "fine", ro, rd, z, cfg, prec)
    return ((col_c - target) ** 2).mean(), ((col_f - target) ** 2).mean()


def train_steps(W0: dict, data: dict, cfg: dict, seed: int, steps: int, n_rand: int,
                prec: str = "bfloat16", fault: str = "") -> dict:
    """`steps` Adam steps from W0 on image-mode batches (image step % N,
    n_rand pixels), each step's draws from a generator seeded with
    (seed << 32) + step on the data's device, in the program's order: the
    pixel indices, the kernel's int32 jitter seed, the fine quantiles.
    data holds K scenes, (K, N, H * W, 3); with K > 1 every leaf of W0
    stacks them (K, ...) and scene k draws with scene_seed(seed, k) for
    seed, the multi-scene trainer's convention (the scenes share nothing).
    -> {"losses": [[coarse, fine] of each scene, per step], "grad1": {leaf:
    gradient of step 1}, "change": {leaf: parameters after `steps` minus
    W0}}. fault plants one of the check's faults: "half_batch" (the mean
    over the first half of the rays), "altered" (every gradient doubled, a
    mean's divisor lost)."""
    rays_o, rays_d, pixels = data["rays_o"], data["rays_d"], data["pixels"]
    dev = rays_o.device
    K, n_img, hw = rays_o.shape[:3]
    seeds = [seed] if K == 1 else [common.scene_seed(seed, k) for k in range(K)]
    W = {k: v.clone() for k, v in W0.items()}
    state, losses, grad1 = {}, [], None
    for step in range(steps):
        params = {k: v.detach().requires_grad_(True) for k, v in W.items()}
        per_scene = []
        with torch.enable_grad():
            for k in range(K):
                gen = torch.Generator(device=dev).manual_seed((seeds[k] << 32) + step)
                inds = torch.randint(0, hw, (n_rand,), generator=gen, device=dev)
                kseed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32,
                                          device=dev).item())
                if fault == "half_batch":
                    inds = inds[: n_rand // 2]
                img = step % n_img
                ro, rd, tgt = rays_o[k, img][inds], rays_d[k, img][inds], pixels[k, img][inds]
                Wk = params if K == 1 else {n: p[k] for n, p in params.items()}
                per_scene += step_loss(Wk, ro, rd, tgt, kseed, lambda n=inds.shape[0]: torch.rand(
                    (n, cfg["n_fine"]), generator=gen, dtype=torch.float32, device=dev),
                    cfg, prec)
            grads = torch.autograd.grad(sum(per_scene), list(params.values()))
        grads = dict(zip(params, grads))
        if fault == "altered":
            grads = {k: 2.0 * g for k, g in grads.items()}
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        common.adam_step(W, grads, state, cfg["lr"])
        losses.append([x.item() for x in per_scene])
    return {"losses": losses, "grad1": grad1, "change": {k: W[k] - W0[k] for k in W}}
