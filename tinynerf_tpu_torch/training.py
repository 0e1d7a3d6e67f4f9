"""Single-device training core (TinyNeRF and the full NeRF).

Port of tinynerf_tpu/training.py:37-459: each step draws a ray batch
(image mode: n_rand pixels of image step % N; pool mode: n_rand pixels
of every train image; either restricted to the central precrop window
for the first precrop_iters steps), takes the gradient of a loss (by
default the reference recipe's TinyNeRF MSE: jittered stratified
samples, encode -> MLP -> composite; the full NeRF plugs in
models/nerf.make_hierarchical_loss) or a fused grad_fn, adds an optional
extra gradient (the sparsity prior, ops/regularizers.py), and updates
with the optimizer of make_optimizer: Adam (b1 0.9, b2 0.999, eps 1e-8),
or AdamW, with an optional exponential lr schedule and EMA of the
parameters (optax's chain in the JAX package). The sigma-noise std
decays by noise_scale; SigmaDeathDetector and background_psnr are the
trainer's watchdog.

Randomness: the JAX package derives every step's draws from
fold_in(key, step). Here each step gets a torch.Generator seeded from
(seed, step) on the training device (step_generator), so any step can be
replayed on its own and a resumed run draws the batches of an
uninterrupted one. The generator draws, in order, the pixel indices
(and, only during a precrop warmup, the pixels inside the window), the
sigma-noise (when on), and the jitter (eager path) or the kernel's int32
seed (fused path). A draw exists only while its lever is on, so with
every lever off the stream is the reference recipe's. The sparsity
prior's points come from a generator of their own, seeded from (seed,
step) and a salt (prior_generator), which every rank of a parallel run
seeds alike.

PyTorch runs eagerly: a block is a Python loop over its steps, and its
metrics stay on the device until the caller reads them (CUDA graphs are
the later analogue of the lax.scan block).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import positional_encoding
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render
from tinynerf_tpu_torch.utils.metrics import mse2psnr


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """Hyperparameters of one training step, with the JAX package's names,
    defaults and meaning (tinynerf_tpu/training.py:37-103). Every lever's
    default is off: the reference recipe."""

    n_rand: int = 2048
    n_samples: int = 64
    near: float = 2.0
    far: float = 6.0
    num_freqs: int = 10
    lr: float = 5e-4
    # > 0: lr * lr_decay_factor ** (count / lr_decay_steps), not staircase.
    lr_decay_steps: int = 0
    lr_decay_factor: float = 0.1
    white_bkgd: bool = True
    # Train-time N(0, std) noise on raw density pre-ReLU; 0.0 = off.
    sigma_noise_std: float = 0.0
    # > 0: the noise decays linearly to sigma_noise_floor over this many
    # steps (noise_scale).
    sigma_noise_decay_steps: int = 0
    sigma_noise_floor: float = 0.0
    # AdamW's decoupled decay on the weight matrices (ndim >= 2); 0 = Adam.
    weight_decay: float = 0.0
    # With lr_decay_steps: the schedule's lower bound (optax end_value).
    lr_floor: float = 0.0
    # > 0: the optimizer keeps ema = d * ema + (1 - d) * params.
    ema_decay: float = 0.0
    # "image": one image a step (step % N); "pool": every train pixel.
    ray_sampling: str = "image"
    # > 0: the first precrop_iters steps draw only from the central
    # precrop_frac window of each image (image_hw = (H, W) required).
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    image_hw: Any = None
    model_cfg: TinyNeRFConfig = TinyNeRFConfig()


def exponential_lr(lr: float, count: int, decay_steps: int = 0, decay_factor: float = 0.1,
                   lr_floor: float = 0.0) -> float:
    """optax.exponential_decay(lr, decay_steps, decay_factor,
    end_value=lr_floor or None) at the optimizer's count: not staircase;
    constant without decay_steps or with a zero factor; the floor a lower
    bound when the factor is below 1, else an upper one."""
    if decay_steps <= 0 or decay_factor == 0 or count <= 0:
        return lr
    value = lr * decay_factor ** (count / decay_steps)
    if lr_floor > 0:
        value = max(value, lr_floor) if decay_factor < 1 else min(value, lr_floor)
    return value


class TrainOptimizer:
    """The JAX package's make_optimizer (tinynerf_tpu/training.py:149-181)
    in PyTorch's idiom: torch.optim.Adam, or with weight_decay
    torch.optim.AdamW over two parameter groups (the decay on the
    parameters of ndim >= 2 only, as optax's mask), with two additions:

    - before every step each group's lr is set from the schedule at the
      optimizer's own count, taken before it is incremented (optax's
      scale_by_schedule), so a resumed run keeps its lr;
    - after every step, with ema_decay, ema = d * ema + (1 - d) * params
      (optax.chain(base, ema_of_params(d))); `ema` starts as a copy of the
      parameters and lists one tensor per parameter, in their order.

    torch's AdamW puts lr * wd * p on the pre-update p, as optax's adamw
    does. batch_dims leading axes of every parameter are stacked scenes
    (multiscene.py), which the decay mask does not count: every update is
    elementwise and the schedule runs on the one shared count, so one
    optimizer over K stacked scenes is K optimizers in lockstep. `state`,
    `param_groups` and `zero_grad` are the base
    optimizer's; the checkpoints (utils/checkpoint.py) write all of it in
    optax's state tree."""

    def __init__(self, params, lr: float, decay_steps: int = 0, decay_factor: float = 0.1,
                 weight_decay: float = 0.0, lr_floor: float = 0.0, ema_decay: float = 0.0,
                 batch_dims: int = 0):
        self.params = list(params)
        self.lr, self.decay_steps, self.decay_factor = lr, decay_steps, decay_factor
        self.weight_decay, self.lr_floor, self.ema_decay = weight_decay, lr_floor, ema_decay
        kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
        if weight_decay > 0:
            groups = [{"params": [p for p in self.params if p.ndim - batch_dims >= 2],
                       "weight_decay": weight_decay},
                      {"params": [p for p in self.params if p.ndim - batch_dims < 2],
                       "weight_decay": 0.0}]
            self.base = torch.optim.AdamW([g for g in groups if g["params"]], **kw)
        else:
            self.base = torch.optim.Adam(self.params, **kw)
        self.ema = ([p.detach().clone() for p in self.params] if ema_decay > 0 else None)

    @property
    def state(self):
        return self.base.state

    @property
    def param_groups(self):
        return self.base.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    def count(self) -> int:
        """Updates applied so far (Adam's step count; 0 before the first)."""
        st = self.base.state.get(self.params[0])
        return int(st["step"]) if st else 0

    def lr_at(self, count: int) -> float:
        return exponential_lr(self.lr, count, self.decay_steps, self.decay_factor, self.lr_floor)

    @torch.no_grad()
    def step(self) -> None:
        lr = self.lr_at(self.count())
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        if self.ema is not None:
            torch._foreach_mul_(self.ema, self.ema_decay)
            torch._foreach_add_(self.ema, self.params, alpha=1.0 - self.ema_decay)


def make_optimizer(params, lr: float, decay_steps: int = 0, decay_factor: float = 0.1,
                   weight_decay: float = 0.0, lr_floor: float = 0.0,
                   ema_decay: float = 0.0, batch_dims: int = 0) -> TrainOptimizer:
    """Adam as optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) (both step by
    lr * m_hat / (sqrt(v_hat) + eps)), with the levers of the JAX
    package's make_optimizer (TrainOptimizer)."""
    return TrainOptimizer(params, lr, decay_steps, decay_factor, weight_decay, lr_floor,
                          ema_decay, batch_dims)


def settings_optimizer(params, s: TrainSettings, batch_dims: int = 0) -> TrainOptimizer:
    return make_optimizer(params, s.lr, s.lr_decay_steps, s.lr_decay_factor,
                          weight_decay=s.weight_decay, lr_floor=s.lr_floor,
                          ema_decay=s.ema_decay, batch_dims=batch_dims)


class SigmaDeathDetector:
    """Declares a run dead when its render has collapsed to the background
    (tinynerf_tpu/training.py:193-233): once raw sigma is negative at
    every sample, the ReLU's gradients are zero, Adam's momentum keeps it
    there, and the train PSNR pins at the PSNR of rendering the
    background for every pixel (`bg_psnr`). `window` consecutive logged
    PSNRs within `margin` dB of that floor, after `grace` steps, mean
    dead. A floor of 60 dB or more (an all-background capture) disables
    the check."""

    def __init__(self, bg_psnr: float, margin: float = 1.0, window: int = 20,
                 grace: int = 1000):
        self.bg_psnr = float(bg_psnr)
        self.margin = float(margin)
        self.window = int(window)
        self.grace = int(grace)
        self.enabled = self.bg_psnr < 60.0
        self._run = 0
        self.first_pinned_step = None

    def update(self, step: int, psnr: float) -> bool:
        """Record one logged train PSNR; True declares sigma death."""
        if not self.enabled or step < self.grace:
            return False
        if psnr < self.bg_psnr + self.margin:
            if self._run == 0:
                self.first_pinned_step = step
            self._run += 1
        else:
            self._run = 0
            self.first_pinned_step = None
        return self._run >= self.window


def background_psnr(pixels: torch.Tensor, white_bkgd: bool = True) -> float:
    """PSNR of predicting the background colour for every train pixel: the
    score a sigma-dead render pins at."""
    bg = 1.0 if white_bkgd else 0.0
    mse = float(torch.mean((pixels.float() - bg) ** 2))
    return float(-10.0 * math.log10(max(mse, 1e-10)))


def noise_scale(s, step: int) -> float:
    """The sigma-noise std's factor at `step` (noise_scale_kwargs,
    tinynerf_tpu/training.py:250-265): 1.0 without decay; with
    sigma_noise_decay_steps d, clip(1 - step / d, floor / std, 1) in
    float32, as the JAX package computes it."""
    decay, std = s.sigma_noise_decay_steps, s.sigma_noise_std
    if decay <= 0 or std <= 0.0:
        return 1.0
    floor_frac = min(max(s.sigma_noise_floor / std, 0.0), 1.0)
    x = torch.tensor(1.0) - torch.tensor(float(step)) / torch.tensor(float(decay))
    return float(torch.clamp(x, torch.tensor(floor_frac), torch.tensor(1.0)))


_MASK64 = (1 << 64) - 1
_PRIOR_SALT = 0x5FA1  # the JAX package's fold_in salt of the prior's points


def mix_seed(*parts: int) -> int:
    """A 64-bit seed from integers (splitmix64 over each in turn)."""
    h = 0
    for p in parts:
        h = (h ^ (int(p) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 31
    return h


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from (seed, step)."""
    return torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))


def prior_generator(seed: int, step: int, device) -> torch.Generator:
    """The sparsity prior's generator of one step: seeded from (seed,
    step) and a salt, the same on every rank of a parallel run."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, step, _PRIOR_SALT))


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


def precrop_window(H: int, W: int, frac: float) -> Tuple[int, int, int, int]:
    """(ch, cw, row0, col0): the central crop window of an H x W image,
    the JAX package's arithmetic (tinynerf_tpu/training.py:323-325)."""
    ch, cw = max(1, int(H * frac)), max(1, int(W * frac))
    return ch, cw, (H - ch) // 2, (W - cw) // 2


def precrop_pixels(kk: torch.Tensor, H: int, W: int, frac: float) -> torch.Tensor:
    """Window indices kk in [0, ch * cw) -> row-major pixel indices of the
    H x W image (tinynerf_tpu/training.py:327-328)."""
    ch, cw, row0, col0 = precrop_window(H, W, frac)
    return (row0 + kk // cw) * W + (col0 + kk % cw)


def draw_ray_batch(s, generator: torch.Generator, step: int, rays_o_all, rays_d_all, pixels):
    """n_rand rays -> (ro, rd, target) (tinynerf_tpu/training.py:300-359).
    Image mode: pixels of image step % N; pool mode: pixels of the (N *
    H * W) pool of every train image. While step < precrop_iters a second
    draw, of window indices, replaces each pixel by one in the image's
    central window (pool mode keeps the drawn image)."""
    if s.ray_sampling not in ("image", "pool"):
        raise ValueError(f"ray_sampling={s.ray_sampling!r} (expected 'image'|'pool')")
    n_images, hw = rays_o_all.shape[0], rays_o_all.shape[1]
    pool = s.ray_sampling == "pool"
    gdev = generator.device
    inds = torch.randint(0, n_images * hw if pool else hw, (s.n_rand,), generator=generator,
                         device=gdev)
    if s.precrop_iters > 0:
        if s.image_hw is None or s.image_hw[0] * s.image_hw[1] != hw:
            raise ValueError(
                "precrop_iters > 0 requires image_hw=(H, W) of the training images in settings "
                "(the train driver sets it from the loaded data)")
        if step < s.precrop_iters:
            H, W = s.image_hw
            ch, cw, _, _ = precrop_window(H, W, s.precrop_frac)
            kk = torch.randint(0, ch * cw, (s.n_rand,), generator=generator, device=gdev)
            center = precrop_pixels(kk, H, W, s.precrop_frac)
            inds = (inds // hw) * hw + center if pool else center
    inds = inds.to(rays_o_all.device)
    if pool:
        return tuple(t.reshape(n_images * hw, 3)[inds] for t in (rays_o_all, rays_d_all, pixels))
    img_i = step % n_images
    return rays_o_all[img_i][inds], rays_d_all[img_i][inds], pixels[img_i][inds]


def add_extra_grads(model, seed: int, step: int, device, extra_grad_fn) -> None:
    """Add extra_grad_fn(model, prior_generator(seed, step)) (a list aligned
    to model.parameters(), e.g. the sparsity prior) into each parameter's
    .grad, whichever path wrote it."""
    from tinynerf_tpu_torch.ops.regularizers import add_grads

    add_grads(model, extra_grad_fn(model, prior_generator(seed, step, device)))


def _step_body(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels, s, loss, grad_fn,
               extra_grad_fn=None):
    """One step: draw, gradient (grad_fn writes .grad; else autograd of
    `loss`), the extra gradient added, the optimizer's update. Returns
    the step's metrics (device tensors). Autograd is on for the step
    whatever the caller's grad mode."""
    gen = step_generator(seed, step, rays_o_all.device)
    ro, rd, target = draw_ray_batch(s, gen, step, rays_o_all, rays_d_all, pixels)
    scale = noise_scale(s, step)
    optimizer.zero_grad(set_to_none=True)
    if grad_fn is not None:
        _, metrics = grad_fn(model, ro, rd, target, gen, noise_scale=scale)
    else:
        with torch.enable_grad():
            value, metrics = loss(model, ro, rd, target, gen, s, noise_scale=scale)
            value.backward()
    if extra_grad_fn is not None:
        add_extra_grads(model, seed, step, rays_o_all.device, extra_grad_fn)
    optimizer.step()
    return metrics


def make_train_step(s: TrainSettings, loss=None, grad_fn=None, extra_grad_fn=None):
    """(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels) ->
    metrics; updates model and optimizer in place. `loss` is any (model,
    ro, rd, target, generator, s, noise_scale=1.0) -> (scalar, metrics);
    it defaults to the TinyNeRF loss_fn (models/nerf.make_hierarchical_loss
    plugs in the full NeRF's). grad_fn (model, ro, rd, target, generator,
    noise_scale=1.0) -> (loss, metrics), writing each parameter's .grad,
    replaces autograd of it. extra_grad_fn (model, generator) -> grads
    (ops/regularizers.make_sparsity_grad_fn) is added to the gradient."""
    loss = loss or loss_fn

    def train_step(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels):
        return _step_body(model, optimizer, seed, step, rays_o_all, rays_d_all, pixels, s, loss,
                          grad_fn, extra_grad_fn)

    return train_step


def make_train_block(s: TrainSettings, block_size: int, loss=None, grad_fn=None,
                     extra_grad_fn=None):
    """`block_size` consecutive steps: (model, optimizer, seed, step0,
    rays_o_all, rays_d_all, pixels) -> metrics with a leading block axis
    (device tensors; every metric key stacked). grad_fn
    (fused_train.make_fused_grad_fn, fused_nerf_train.make_fused_nerf_grad_fn)
    routes the gradients through a fused CUDA train kernel; extra_grad_fn
    adds a regularizer's gradient (see make_train_step)."""
    step_fn = make_train_step(s, loss, grad_fn, extra_grad_fn)

    def train_block(model, optimizer, seed, step0, rays_o_all, rays_d_all, pixels):
        ms = [step_fn(model, optimizer, seed, step0 + i, rays_o_all, rays_d_all, pixels)
              for i in range(block_size)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return train_block


def init_train_state(generator: torch.Generator, s: TrainSettings, device=None, init_fn=None):
    """(model, optimizer) freshly initialized; the weights are drawn on
    the CPU from `generator`, then moved to `device`. init_fn(generator,
    device) -> model overrides the TinyNeRF (e.g. a models/nerf.NeRF).
    The optimizer is settings_optimizer's."""
    if init_fn is None:
        model = TinyNeRF(s.model_cfg, generator=generator, device=device)
    else:
        model = init_fn(generator, device)
    return model, settings_optimizer(model.parameters(), s)
