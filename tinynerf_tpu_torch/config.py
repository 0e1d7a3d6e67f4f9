"""Render and training configuration: the TinyNeRF fields of
tinynerf_tpu/config.py:26-48, 77-131, 137-160, 211-236, with the same
names, defaults and meaning, plus the device to run on.

One divergence each for the two kernels: `fused` and `fused_train`
default to True here, because the hand-written CUDA kernels are the
port's render and train routes (kernels/fused_render.py,
kernels/fused_train.py). `--no-fused` and `--no-fused-train` select the
eager torch composition of ops/ and models/ (with autograd for
training), the counterparts of the JAX package's default XLA paths.

The full NeRF's fields (model, n_fine, proposal, nerf_depth,
nerf_skip_at, num_freqs_dir, rgb_hidden) and nerf_cfg() follow
tinynerf_tpu/config.py:51-63, 173-184; train_settings() serves both
models (train.py hands n_fine and nerf_cfg() to the NeRF's loss and
fused grad_fn). The training levers (ray_sampling, precrop, the
sigma-noise schedule, the lr schedule, weight decay, the EMA, the
sparsity prior), the sigma-death watchdog, the holdout modes, eval_every
and ckpt_keep are the JAX package's, every one off by default but the
watchdog (death_check), as there. proposal="occupancy" trains and serves
the single-MLP occupancy-grid proposal (ops/occupancy.py); ndc
reprojects a forward-facing capture's rays to NDC space and samples t in
[0, 1] (train_settings() swaps near/far, tinynerf_tpu/config.py:133,
219-220). The grid family's fields (grid_*, model="grid") and grid_cfg()
follow tinynerf_tpu/config.py:65-75, 186-210; the family runs in eager
torch whatever fused and fused_train say (it has no kernel). Instant-NGP's
published form adds grid_dir_encoding, grid_density_activation and
grid_rgb_reads_density (models/grid_nerf.py) and the optimizer's
adam_b2, adam_eps, l2_reg and sparse_adam (training.MaskedAdam), every
one off by default.
profile_dir (tinynerf_tpu/config.py:150) names the directory of the
training loop's torch.profiler trace (utils/profiling.trace; the JAX
package's jax.profiler trace). data_parallel, sample_parallel and distributed
(tinynerf_tpu/config.py:144-149) select parallel/: a rank of a
torch.distributed process group is one device of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tinynerf_tpu_torch.models.grid_nerf import GridNeRFConfig
from tinynerf_tpu_torch.models.nerf import NeRFConfig
from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.training import TrainSettings


@dataclass
class Config:
    iters: int = 20000  # total training steps
    n_rand: int = 2048  # random rays per step
    n_samples: int = 64  # samples along each ray
    lr: float = 5e-4
    lr_decay_steps: int = 0  # >0: exponential decay over this many steps
    lr_decay_factor: float = 0.1  # final lr = lr * factor (NeRF schedule)
    near: float = 2.0
    far: float = 6.0
    log_every: int = 50
    preview_every: int = 500
    ckpt_every: int = 1000
    ckpt_path: str = "checkpoints/tinynerf_latest.npz"
    out_dir: str = "outputs"
    resume: bool = True
    preview_pose: Optional[int] = None  # None -> the pose after the last trained one
    hidden: int = 128
    depth: int = 4
    skip_at: int = 2
    num_freqs: int = 10
    seed: int = 0
    chunk: int = 8192  # rays per render chunk
    model: str = "tinynerf"  # "tinynerf" | "nerf" (viewdirs + coarse/fine) | "grid"
    n_fine: int = 64  # fine samples per ray (nerf model only)
    proposal: str = "coarse"  # nerf proposal: "coarse" MLP | "occupancy" grid (one MLP)
    nerf_depth: int = 8
    nerf_skip_at: int = 4
    num_freqs_dir: int = 4
    rgb_hidden: int = 64
    grid_levels: int = 8  # grid family: feature-pyramid levels
    grid_features: int = 2  # features per level
    grid_base_res: int = 16  # coarsest grid resolution
    grid_max_res: int = 128  # finest grid resolution
    grid_table_size: int = 1 << 17  # entries per level cap (finer levels hash)
    grid_hidden: int = 64  # grid-MLP width (both branches)
    grid_encode_impl: str = "loop"  # the JAX package's gather strategy (the port has one)
    grid_dir_encoding: str = "fourier"  # "fourier" | "sh": Instant-NGP's 16 SH components
    grid_density_activation: str = "relu"  # "relu" | "exp": Instant-NGP's log-space density
    grid_rgb_reads_density: bool = False  # colour MLP reads all 16 density outputs (Instant-NGP)
    ray_sampling: str = "image"  # "image": one image a step | "pool": every train pixel
    precrop_iters: int = 0  # >0: the first N steps draw from the central window
    precrop_frac: float = 0.5  # side fraction of that window
    death_check: bool = True  # abort (rc 3) when the train PSNR pins at the background's
    death_margin: float = 1.0  # ... within this many dB of it
    death_window: int = 20  # ... for this many consecutive log points
    death_grace: int = 1000  # ... after this many steps
    sigma_noise_std: float = 0.0  # train-time N(0, std) noise on raw density pre-ReLU
    sigma_noise_decay_steps: int = 0  # >0: decay the noise linearly over N steps
    sigma_noise_floor: float = 0.0  # with decay: decay to this std instead of 0
    weight_decay: float = 0.0  # AdamW decay on the weight matrices (0: Adam)
    adam_b2: float = 0.999  # Adam's second-moment decay (Instant-NGP: 0.99)
    adam_eps: float = 1e-8  # Adam's epsilon (Instant-NGP: 1e-15)
    l2_reg: float = 0.0  # coupled L2 on the weight matrices (Instant-NGP: 1e-6)
    sparse_adam: bool = False  # --model grid: skip table entries with exactly zero gradient
    lr_floor: float = 0.0  # with lr_decay_steps: the schedule's lower bound
    sigma_sparsity: float = 0.0  # >0: free-space density prior lam (e.g. 1e-3)
    sigma_sparsity_points: int = 8192  # the prior's points per step
    ema_decay: float = 0.0  # >0: Polyak average of the params, twin <ckpt>.ema.npz
    ndc: bool = False  # forward-facing capture: rays in NDC space, t in [0, 1] (--near/--far ignored)
    data_path: str = "data/tiny_nerf_data.npz"
    allow_synthetic: bool = True  # fall back to the procedural scene offline
    bf16: bool = True  # bfloat16 matmul inputs (f32 params and accumulation)
    fused: bool = True  # render through the fused CUDA kernel
    fused_train: bool = True  # train through the fused CUDA fwd+bwd kernels
    data_parallel: bool = False  # shard ray batches over the ranks of the process group
    sample_parallel: int = 1  # with data_parallel: size of the mesh's
    # sample axis (shards the per-ray sample axis / fine union via the
    # blockwise composite; parallel/train.py)
    distributed: bool = False  # join the launcher's process group (parallel/mesh.py)
    metrics_path: Optional[str] = None  # JSONL metrics log
    profile_dir: Optional[str] = None  # torch.profiler trace output (Chrome trace JSON)
    holdout: int = 0  # poses excluded from training, scored at the end
    holdout_mode: str = "tail"  # "tail": the last N poses | "strided": N spread evenly
    eval_every: int = 0  # >0: score the held-out views every N steps (needs holdout)
    ckpt_keep: int = 0  # >0: also keep the last N step-stamped checkpoint copies
    device: str = "cuda"

    def model_cfg(self) -> TinyNeRFConfig:
        return TinyNeRFConfig(
            in_dim=encoding_dim(self.num_freqs, include_input=True),
            hidden=self.hidden,
            depth=self.depth,
            skip_at=self.skip_at,
            compute_dtype=torch.bfloat16 if self.bf16 else torch.float32,
        )

    def nerf_cfg(self) -> NeRFConfig:
        return NeRFConfig(
            num_freqs=self.num_freqs,
            num_freqs_dir=self.num_freqs_dir,
            hidden=self.hidden,
            depth=self.nerf_depth,
            skip_at=self.nerf_skip_at,
            rgb_hidden=self.rgb_hidden,
            compute_dtype=torch.bfloat16 if self.bf16 else torch.float32,
        )

    def grid_cfg(self, aabb=None) -> GridNeRFConfig:
        """GridNeRFConfig; aabb ((2, 3) array-like) replaces the default scene
        box: the driver derives it from the capture's rays and persists it in
        the checkpoint's meta."""
        kw = {}
        if aabb is not None:
            box = torch.as_tensor(aabb, dtype=torch.float64).reshape(6)
            kw["aabb"] = tuple(float(v) for v in box)
        return GridNeRFConfig(
            n_levels=self.grid_levels,
            features=self.grid_features,
            base_res=self.grid_base_res,
            max_res=self.grid_max_res,
            table_size=self.grid_table_size,
            hidden=self.grid_hidden,
            num_freqs_dir=self.num_freqs_dir,
            compute_dtype=torch.bfloat16 if self.bf16 else torch.float32,
            encode_impl=self.grid_encode_impl,
            dir_encoding=self.grid_dir_encoding,
            density_activation=self.grid_density_activation,
            rgb_reads_density=self.grid_rgb_reads_density,
            **kw,
        )

    def train_settings(self) -> TrainSettings:
        if self.ray_sampling not in ("image", "pool"):
            raise ValueError(f"ray_sampling={self.ray_sampling!r} (expected 'image'|'pool')")
        return TrainSettings(
            n_rand=self.n_rand,
            n_samples=self.n_samples,
            near=0.0 if self.ndc else self.near,
            far=1.0 if self.ndc else self.far,
            ray_sampling=self.ray_sampling,
            precrop_iters=self.precrop_iters,
            precrop_frac=self.precrop_frac,
            sigma_noise_std=self.sigma_noise_std,
            sigma_noise_decay_steps=self.sigma_noise_decay_steps,
            sigma_noise_floor=self.sigma_noise_floor,
            weight_decay=self.weight_decay,
            adam_b2=self.adam_b2,
            adam_eps=self.adam_eps,
            l2_reg=self.l2_reg,
            sparse_adam=self.sparse_adam,
            lr_floor=self.lr_floor,
            ema_decay=self.ema_decay,
            num_freqs=self.num_freqs,
            lr=self.lr,
            lr_decay_steps=self.lr_decay_steps,
            lr_decay_factor=self.lr_decay_factor,
            white_bkgd=True,
            model_cfg=self.model_cfg(),
        )
