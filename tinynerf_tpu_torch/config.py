"""Render and training configuration: the TinyNeRF fields of
tinynerf_tpu/config.py:26-48, 102, 137-160, 211-236, with the same
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
fused grad_fn). Fields that only the grid family, the occupancy
proposal or the flagship training levers use are not ported yet
(ROADMAP.md, queue 1). data_parallel, sample_parallel and distributed
(tinynerf_tpu/config.py:144-149) select parallel/: a rank of a
torch.distributed process group is one device of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

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
    model: str = "tinynerf"  # "tinynerf" | "nerf" (viewdirs + coarse/fine)
    n_fine: int = 64  # fine samples per ray (nerf model only)
    proposal: str = "coarse"  # nerf proposal: "coarse" MLP | "occupancy" grid (not ported)
    nerf_depth: int = 8
    nerf_skip_at: int = 4
    num_freqs_dir: int = 4
    rgb_hidden: int = 64
    sigma_noise_std: float = 0.0  # train-time N(0, std) noise on raw density pre-ReLU
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
    holdout: int = 0  # trailing poses excluded from training, scored at the end
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

    def train_settings(self) -> TrainSettings:
        return TrainSettings(
            n_rand=self.n_rand,
            n_samples=self.n_samples,
            near=self.near,
            far=self.far,
            num_freqs=self.num_freqs,
            lr=self.lr,
            white_bkgd=True,
            sigma_noise_std=self.sigma_noise_std,
            model_cfg=self.model_cfg(),
        )
