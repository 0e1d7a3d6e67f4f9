"""Port parity for the fused render kernel module.

On the CPU: fused_render_rays_plain (the kernel's plain version, and
the wrapper's CPU path) against the JAX package's Pallas kernel run in
interpret mode, as tests/test_fused_kernel.py runs it. The CUDA kernel
itself is compared with the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.kernels.fused_render import fused_render_rays as jax_fused
from tinynerf_tpu.models import tinynerf as jmodel
from tinynerf_tpu_torch.kernels.fused_render import (
    fused_render_rays,
    fused_render_rays_plain,
    pack_weights,
)
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax
from tinynerf_tpu_torch.ops.encoding import encoding_dim


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.1).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    # Non-unit lengths: the deltas scale with ||d||.
    rd *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _pair(seed, jdt, tdt, num_freqs=10, hidden=128):
    jcfg = jmodel.TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=jdt)
    params = jmodel.init_tinynerf(jax.random.PRNGKey(seed), jcfg)
    model = TinyNeRF(TinyNeRFConfig(in_dim=jcfg.in_dim, hidden=hidden, compute_dtype=tdt))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return params, jcfg, model


def _both(params, jcfg, model, ro, rd, **kw):
    want = jax_fused(params, jnp.asarray(ro), jnp.asarray(rd), model_cfg=jcfg, interpret=True, **kw)
    with torch.no_grad():
        got = fused_render_rays_plain(model, torch.from_numpy(ro), torch.from_numpy(rd), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_plain_matches_jax_kernel_f32(white_bkgd):
    params, jcfg, model = _pair(0, jnp.float32, torch.float32)
    ro, rd = _rays(100, 0)  # not a multiple of any tile
    got, want = _both(params, jcfg, model, ro, rd, n_samples=64, white_bkgd=white_bkgd)
    assert got.shape == (100, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_plain_matches_jax_kernel_bf16_gates():
    """The JAX package's render parity gates (bench.py:707-718): per-ray
    max error p99.9 < 3e-2, mean < 1e-3, fraction above 3e-2 < 2.5e-3."""
    params, jcfg, model = _pair(1, jnp.bfloat16, torch.bfloat16)
    ro, rd = _rays(100, 2)
    got, want = _both(params, jcfg, model, ro, rd, n_samples=64)
    err = np.abs(got - want).max(axis=1)
    assert np.quantile(err, 0.999) < 3e-2
    assert err.mean() < 1e-3
    assert (err > 3e-2).mean() < 2.5e-3


def test_plain_matches_jax_kernel_small_model():
    """hidden 32, L=4, S=16."""
    params, jcfg, model = _pair(3, jnp.float32, torch.float32, num_freqs=4, hidden=32)
    ro, rd = _rays(37, 4)
    got, want = _both(params, jcfg, model, ro, rd, n_samples=16, num_freqs=4)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_wrapper_takes_plain_version_on_cpu():
    model = TinyNeRF(generator=torch.Generator().manual_seed(0))
    ro, rd = map(torch.from_numpy, _rays(20, 5))
    before = fused_render_rays.launches
    with torch.no_grad():
        got = fused_render_rays(model, ro, rd, n_samples=16, white_bkgd=False)
        want = fused_render_rays_plain(model, ro, rd, n_samples=16, white_bkgd=False)
    assert torch.equal(got, want)
    assert fused_render_rays.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_weights_layout(dtype):
    """Trunk W (in, out) + b per layer, then the head W (hidden, 4) with
    columns r, g, b, sigma and its bias; weights rounded to the compute
    dtype, biases f32."""
    cfg = TinyNeRFConfig(compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(1))
    buf = pack_weights(model, cfg)
    assert buf.dtype == torch.float32 and buf.numel() == 66308
    r = lambda w: w.detach().to(dtype).float()
    off = 0
    for lin in model.layers:
        n = lin.weight.numel()
        assert torch.equal(buf[off:off + n].reshape(lin.in_features, -1), r(lin.weight).t())
        assert torch.equal(buf[off + n:off + n + lin.out_features], lin.bias.detach())
        off += n + lin.out_features
    head = buf[off:off + 128 * 4].reshape(128, 4)
    assert torch.equal(head[:, :3], r(model.rgb[0].weight).t())
    assert torch.equal(head[:, 3], r(model.sigma[0].weight)[0])
    assert torch.equal(buf[-4:-1], model.rgb[0].bias.detach())
