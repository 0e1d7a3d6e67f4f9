"""Single-device training core (TinyNeRF and the full NeRF).

Port of tinynerf_tpu/training.py:37-103, 149-190, 268-297, 300-359,
362-459: each step picks image (step % N), draws n_rand pixels, takes
the gradient of a loss (by default the reference recipe's TinyNeRF MSE:
jittered stratified samples, encode -> MLP -> composite; the full NeRF
plugs in models/nerf.make_hierarchical_loss) or a fused grad_fn, and
updates with Adam (b1 0.9, b2 0.999, eps 1e-8).

Randomness: the JAX package derives every step's draws from
fold_in(key, step). Here each step gets a torch.Generator seeded from
(seed, step) on the training device (step_generator), so any step can be
replayed on its own and a resumed run draws the batches of an
uninterrupted one. The generator draws, in order, the pixel indices,
the sigma-noise (when on), and the jitter (eager path) or the kernel's
int32 seed (fused path).

PyTorch runs eagerly: a block is a Python loop over its steps, and its
metrics stay on the device until the caller reads them (CUDA graphs are
the later analogue of the lax.scan block).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render
from tinynerf_tpu_torch.utils.metrics import mse2psnr


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Hyperparameters of one training step."""

    n_rand: int = 2048
    n_samples: int = 64
    near: float = 2.0
    far: float = 6.0
    num_freqs: int = 10
    lr: float = 5e-4
    white_bkgd: bool = True
    # Train-time N(0, std) noise on raw density pre-ReLU; 0.0 = off.
    sigma_noise_std: float = 0.0
    model_cfg: TinyNeRFConfig = TinyNeRFConfig()


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    """Adam as optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8): both step by
    lr * m_hat / (sqrt(v_hat) + eps)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def loss_fn(
    model: TinyNeRF,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    generator: torch.Generator,
    s: TrainSettings,
    noise_scale: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MSE loss over one ray batch (jittered sampling from `generator`)."""
    n_rand = rays_o.shape[0]
    noise = None
    if s.sigma_noise_std > 0.0:
        noise = noise_scale * s.sigma_noise_std * torch.randn(
            (n_rand * s.n_samples, 1), generator=generator, dtype=torch.float32,
            device=generator.device,
        ).to(rays_o.device)
    z_vals, pts = stratified_samples(
        s.near, s.far, s.n_samples, rays_o, rays_d, randomized=True, generator=generator
    )
    xenc = positional_encoding(pts.reshape(-1, 3), num_freqs=s.num_freqs)
    rgb, sigma = model(xenc, s.model_cfg, sigma_noise=noise)
    rgb = rgb.reshape(n_rand, s.n_samples, 3)
    sigma = sigma.reshape(n_rand, s.n_samples)
    comp_rgb, _, _, _ = volume_render(rgb, sigma, z_vals, rays_d, white_bkgd=s.white_bkgd)
    loss = torch.mean((comp_rgb - target.float()) ** 2)
    return loss, {"loss": loss.detach(), "psnr": mse2psnr(loss.detach())}


def draw_ray_batch(s, generator: torch.Generator, step: int, rays_o_all, rays_d_all, pixels):
    """Image mode (tinynerf_tpu/training.py:351-358): n_rand pixels of
    image step % N -> (ro, rd, target). Pool sampling and precrop are
    flagship levers not ported yet."""
    if getattr(s, "ray_sampling", "image") != "image" or getattr(s, "precrop_iters", 0) > 0:
        raise NotImplementedError(
            "pool ray sampling and precrop are not ported yet (ROADMAP.md, queue 1, item 8)"
        )
    n_images, hw = rays_o_all.shape[0], rays_o_all.shape[1]
    img_i = step % n_images
    inds = torch.randint(0, hw, (s.n_rand,), generator=generator, device=generator.device)
    inds = inds.to(rays_o_all.device)
    return rays_o_all[img_i][inds], rays_d_all[img_i][inds], pixels[img_i][inds]


def _step_body(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels, s, loss, grad_fn):
    """One step: draw, gradient (grad_fn writes .grad; else autograd of
    `loss`), Adam update. Returns the step's metrics (device tensors).
    Autograd is on for the step whatever the caller's grad mode."""
    gen = step_generator(seed, step, rays_o_all.device)
    ro, rd, target = draw_ray_batch(s, gen, step, rays_o_all, rays_d_all, pixels)
    optimizer.zero_grad(set_to_none=True)
    if grad_fn is not None:
        _, metrics = grad_fn(model, ro, rd, target, gen)
    else:
        with torch.enable_grad():
            value, metrics = loss(model, ro, rd, target, gen, s)
            value.backward()
    optimizer.step()
    return metrics


def make_train_step(s: TrainSettings, loss=None, grad_fn=None):
    """(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels) ->
    metrics; updates model and optimizer in place. `loss` is any (model,
    ro, rd, target, generator, s) -> (scalar, metrics); it defaults to the
    TinyNeRF loss_fn (models/nerf.make_hierarchical_loss plugs in the
    full NeRF's). grad_fn (model, ro, rd, target, generator) -> (loss,
    metrics), writing each parameter's .grad, replaces autograd of it."""
    loss = loss or loss_fn

    def train_step(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels):
        return _step_body(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels, s, loss,
                          grad_fn)

    return train_step


def make_train_block(s: TrainSettings, block_size: int, loss=None, grad_fn=None):
    """`block_size` consecutive steps: (model, optimizer, seed, step0,
    rays_o_all, rays_d_all, pixels) -> metrics with a leading block axis
    (device tensors; every metric key stacked). grad_fn
    (fused_train.make_fused_grad_fn, fused_nerf_train.make_fused_nerf_grad_fn)
    routes the gradients through a fused CUDA train kernel."""
    step_fn = make_train_step(s, loss, grad_fn)

    def train_block(model, optimizer, seed, step0, rays_o_all, rays_d_all, pixels):
        ms = [step_fn(model, optimizer, seed, step0 + i, rays_o_all, rays_d_all, pixels)
              for i in range(block_size)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return train_block


def init_train_state(generator: torch.Generator, s: TrainSettings, device=None, init_fn=None):
    """(model, optimizer) freshly initialized; the weights are drawn on
    the CPU from `generator`, then moved to `device`. init_fn(generator,
    device) -> model overrides the TinyNeRF (e.g. a models/nerf.NeRF)."""
    if init_fn is None:
        model = TinyNeRF(s.model_cfg, generator=generator, device=device)
    else:
        model = init_fn(generator, device)
    return model, make_optimizer(model.parameters(), s.lr)
