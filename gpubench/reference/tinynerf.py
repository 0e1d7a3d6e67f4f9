"""Plain PyTorch reference of TinyNeRF (the reference recipe of
avihaig/tiny-nerf-pytorch, src/nerf.py and src/train.py): a depth x
hidden ReLU trunk on the encoded position, the encoding joined again after
layer skip_at, rgb = sigmoid and sigma = ReLU heads on the trunk,
stratified samples in [near, far], a white background, the photometric
MSE and Adam; several independent scenes side by side, each with its own
weights, rays and draws. float32 sums, TF32 off, the products' operands in the configuration's
precision; prec="fp8" is the control.
"""

from __future__ import annotations

import torch

from gpubench.reference import common
from gpubench.reference.philox import jitter_depths


def layer_shapes(cfg: dict) -> dict:
    h, e = cfg["hidden"], 3 + 6 * cfg["num_freqs"]
    shapes, last = {}, e
    for i in range(cfg["depth"]):
        shapes[f"layers.{i}"] = (h, last)
        last = h + e if i == cfg["skip_at"] - 1 else h
    shapes["sigma.0"] = (1, h)
    shapes["rgb.0"] = (3, h)
    return shapes


def init_weights(cfg: dict, generator: torch.Generator, device, n_scenes: int = 1) -> dict:
    shapes, fan_in = {}, {}
    for name, (o, i) in layer_shapes(cfg).items():
        for kind, shape in (("weight", (o, i)), ("bias", (o,))):
            shapes[f"{name}.{kind}"] = shape
            fan_in[f"{name}.{kind}"] = i
    return common.uniform_init(shapes, fan_in, generator, device, n_scenes)


def mlp(W: dict, x_enc: torch.Tensor, cfg: dict, prec: str, raw: bool = False):
    """-> (rgb, sigma), or with raw=True the pre-ReLU density alone."""
    def lin(name, x):
        return common.linear(x, W[f"{name}.weight"], W[f"{name}.bias"], prec)

    h = x_enc
    for i in range(cfg["depth"]):
        h = torch.relu(lin(f"layers.{i}", h))
        if i == cfg["skip_at"] - 1:
            h = torch.cat([h, x_enc], dim=-1)
    sigma_raw = lin("sigma.0", h)[:, 0]
    if raw:
        return sigma_raw
    return torch.sigmoid(lin("rgb.0", h)), torch.relu(sigma_raw)


@torch.no_grad()
def centre_density(W: dict, ro, rd, cfg: dict) -> None:
    """Shift the density bias, in place, so that the median raw density at
    the grid samples of these rays is 0 (see reference/nerf.py); ro, rd
    (R, 3) for one model, (K, R, 3) for K stacked scenes."""
    if ro.dim() == 3:
        for k in range(ro.shape[0]):
            centre_density({n: v[k] for n, v in W.items()}, ro[k], rd[k], cfg)
        return
    z = common.linspace_depths(ro.shape[0], cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    x_enc = common.encode((ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3),
                          cfg["num_freqs"])
    W["sigma.0.bias"] -= mlp(W, x_enc, cfg, "float32", raw=True).median()


def one_pass(W: dict, ro, rd, z, cfg: dict, prec: str):
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    rgb, sigma = mlp(W, common.encode(pts.reshape(-1, 3), cfg["num_freqs"]), cfg, prec)
    return common.composite(rgb.reshape(R, S, 3), sigma.reshape(R, S), z, rd, cfg["white_bkgd"])


def render_rays(W: dict, ro, rd, cfg: dict, prec: str = "bfloat16"):
    z = common.linspace_depths(ro.shape[0], cfg["n_samples"], cfg["near"], cfg["far"], ro.device)
    return one_pass(W, ro, rd, z, cfg, prec)[0]


def train_steps(W0: dict, data: dict, cfg: dict, seed: int, steps: int, n_rand: int,
                prec: str = "bfloat16", fault: str = "") -> dict:
    """`steps` Adam steps of K scenes side by side from W0 (K, ...): scene
    k draws from a generator seeded with (common.scene_seed(seed, k) << 32) +
    step, first its n_rand pixel indices of image step % N, then the
    kernel's int32 jitter seed. The loss summed over the scenes is each
    scene's own (they share nothing). -> {"losses": [[loss per scene] per
    step], "grad1": {leaf: (K, ...) gradient of step 1}, "change": {leaf:
    (K, ...) change after `steps`}}. fault plants one of the check's faults
    (see reference/nerf.py's train_steps)."""
    rays_o, rays_d, pixels = data["rays_o"], data["rays_d"], data["pixels"]
    dev = rays_o.device
    K, n_img, hw = rays_o.shape[:3]
    W = {k: v.clone() for k, v in W0.items()}
    state, losses, grad1 = {}, [], None
    for step in range(steps):
        params = {k: v.detach().requires_grad_(True) for k, v in W.items()}
        per_scene = []
        with torch.enable_grad():
            for k in range(K):
                gen = torch.Generator(device=dev).manual_seed((common.scene_seed(seed, k) << 32) + step)
                inds = torch.randint(0, hw, (n_rand,), generator=gen, device=dev)
                kseed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, dtype=torch.int32,
                                          device=dev).item())
                if fault == "half_batch":
                    inds = inds[: n_rand // 2]
                img = step % n_img
                ro, rd, tgt = rays_o[k, img][inds], rays_d[k, img][inds], pixels[k, img][inds]
                z = torch.from_numpy(jitter_depths(kseed, inds.shape[0], cfg["n_samples"],
                                                   cfg["near"], cfg["far"])).to(dev)
                col, _ = one_pass({n: p[k] for n, p in params.items()}, ro, rd, z, cfg, prec)
                per_scene.append(((col - tgt) ** 2).mean())
            grads = torch.autograd.grad(sum(per_scene), list(params.values()))
        grads = dict(zip(params, grads))
        if fault == "altered":
            grads = {k: 2.0 * g for k, g in grads.items()}
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        common.adam_step(W, grads, state, cfg["lr"])
        losses.append([x.item() for x in per_scene])
    return {"losses": losses, "grad1": grad1, "change": {k: W[k] - W0[k] for k in W}}
