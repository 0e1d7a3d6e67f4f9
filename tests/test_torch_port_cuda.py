"""The fused render kernel against its plain version, on a CUDA device.

Skips without one. This file imports neither jax nor the JAX package, so
it also runs on a GPU machine that has no JAX (without the suite's
conftest.py, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.kernels.fused_render import fused_render_rays, fused_render_rays_plain
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim


def _rays(n, seed, device):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    # Non-unit lengths: the deltas scale with ||d||.
    rd *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(rd, axis=-1, keepdims=True)
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples,hidden,num_freqs", [(64, 128, 10), (16, 32, 4), (48, 64, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, n_samples, hidden, num_freqs, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(2), device=cuda_device)
    ro, rd = _rays(1001, 6, cuda_device)  # not a multiple of any tile
    kw = dict(n_samples=n_samples, num_freqs=num_freqs)
    before = fused_render_rays.launches
    with torch.no_grad():
        got = fused_render_rays(model, ro, rd, **kw)
        torch.cuda.synchronize()
        want = fused_render_rays_plain(model, ro, rd, **kw)
    assert fused_render_rays.launches == before + 1
    err = (got - want).abs().max(dim=1).values
    # f32: summation order only; bf16: the render parity gates.
    p999 = 5e-4 if dtype == torch.float32 else 3e-2
    assert float(torch.quantile(err, 0.999)) < p999
    assert float((err > 3e-2).float().mean()) < 2.5e-3
