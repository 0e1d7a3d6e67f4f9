"""The fused render (K1) and train (K2) kernels against their plain
versions, and K2's jitter statistics, on a CUDA device.

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


def _train_case(n_samples, hidden, num_freqs, dtype, device, n_rays=256, seed=3):
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    ro, rd = _rays(n_rays, seed, device)
    target = torch.from_numpy(np.random.RandomState(seed).rand(n_rays, 3).astype(np.float32))
    return model, ro, rd, target.to(device)


def _cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples,hidden,num_freqs,noise", [
    (64, 128, 10, False), (16, 32, 4, False), (48, 64, 10, False), (64, 128, 10, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_matches_plain_on_card(cuda_device, n_samples, hidden, num_freqs, noise, dtype):
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads, fused_loss_grads_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    model, ro, rd, target = _train_case(n_samples, hidden, num_freqs, dtype, cuda_device)
    sigma_noise = None
    if noise:
        g = torch.Generator(device=cuda_device).manual_seed(4)
        sigma_noise = torch.randn(ro.shape[0], n_samples, generator=g, device=cuda_device)
    kw = dict(n_samples=n_samples, num_freqs=num_freqs, randomized=False, sigma_noise=sigma_noise)
    before = fused_loss_grads.launches
    loss, grads = fused_loss_grads(model, ro, rd, target, 0, **kw)
    torch.cuda.synchronize()
    want_loss, want = fused_loss_grads_plain(model, ro, rd, target, 0, **kw)
    assert fused_loss_grads.launches == before + 1
    rel = abs(float(loss) - float(want_loss)) / float(want_loss)
    if dtype == torch.float32:
        # Summation order only: the JAX package's own kernel tolerance.
        assert rel < 1e-5
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= 2e-4 * float(w.abs().max()) + 1e-8
    else:
        # bf16 rounds at other places than autograd: bench.py's gates.
        assert rel < 1e-3
        assert min(_cosine(g, w) for g, w in zip(grads, want)) > 0.98


@pytest.mark.cuda
def test_train_kernel_is_deterministic_and_seeded(cuda_device):
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads

    model, ro, rd, target = _train_case(64, 128, 10, torch.bfloat16, cuda_device, n_rays=512)
    runs = [fused_loss_grads(model, ro, rd, target, seed) for seed in (7, 7, 8)]
    (l0, g0), (l1, g1), (l2, g2) = [(float(l), [g.clone() for g in gs]) for l, gs in runs]
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert l0 != l2 and not torch.equal(g0[0], g2[0])


@pytest.mark.cuda
def test_jitter_probe_bins_and_uniformity(cuda_device):
    from tinynerf_tpu_torch.kernels.fused_train import depth_grid, jitter_probe

    R, S, near, far = 4096, 64, 2.0, 6.0
    z = jitter_probe(123, R, S, near, far, tile=1, device=cuda_device)
    assert torch.equal(z, jitter_probe(123, R, S, near, far, tile=8, device=cuda_device))
    assert torch.equal(z, jitter_probe(123, R, S, near, far, tile=1, device=cuda_device))
    assert (z != jitter_probe(124, R, S, near, far, tile=1, device=cuda_device)).float().mean() > 0.99
    grid = depth_grid(S, near, far, cuda_device)
    h = (far - near) / (S - 1)
    s = torch.arange(S, device=cuda_device)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == S - 1, grid, grid + 0.5 * h)
    assert bool(((z >= lower) & (z <= upper)).all())
    u = ((z - lower) / (upper - lower)).double()
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 6 / (12 * n) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 6 * (1 / 180 / n) ** 0.5
    counts = torch.histc(u.float(), bins=10, min=0.0, max=1.0)
    assert float((counts / n - 0.1).abs().max()) < 6 * (0.09 / n) ** 0.5
    corr = torch.corrcoef(torch.stack([u[:-1].reshape(-1), u[1:].reshape(-1)]))[0, 1]
    assert abs(float(corr)) < 6 / n ** 0.5
