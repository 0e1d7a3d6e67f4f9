"""Render configuration: the render-relevant fields of
tinynerf_tpu/config.py:23-48, 137-171, with the same names, defaults and
meaning, plus the device to run on.

One divergence: `fused` defaults to True here, because the fused CUDA
kernel (kernels/fused_render.py) is the port's render route;
`--no-fused` selects the eager composition of ops/ and models/, the
counterpart of the JAX package's default XLA path.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim


@dataclass
class Config:
    n_samples: int = 64  # samples along each ray
    near: float = 2.0
    far: float = 6.0
    out_dir: str = "outputs"
    hidden: int = 128
    depth: int = 4
    skip_at: int = 2
    num_freqs: int = 10
    seed: int = 0
    chunk: int = 8192  # rays per render chunk
    data_path: str = "data/tiny_nerf_data.npz"
    allow_synthetic: bool = True  # fall back to the procedural scene offline
    bf16: bool = True  # bfloat16 matmul inputs (f32 params and accumulation)
    fused: bool = True  # render through the fused CUDA kernel
    device: str = "cuda"

    def model_cfg(self) -> TinyNeRFConfig:
        return TinyNeRFConfig(
            in_dim=encoding_dim(self.num_freqs, include_input=True),
            hidden=self.hidden,
            depth=self.depth,
            skip_at=self.skip_at,
            compute_dtype=torch.bfloat16 if self.bf16 else torch.float32,
        )
