"""Port parity for the fused train kernel module (K2).

On the CPU: fused_loss_grads_plain (the kernel's plain version, and the
wrapper's CPU path) against the reference the JAX package holds its own
kernel to, jax.value_and_grad of the unfused loss on deterministic
depths (tests/test_fused_train.py:36-59). The CUDA kernel itself is
compared with the plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import apply_tinynerf, init_tinynerf
from tinynerf_tpu.ops.encoding import positional_encoding as jax_encoding
from tinynerf_tpu.ops.sampling import stratified_samples as jax_stratified
from tinynerf_tpu.ops.volume import volume_render as jax_volume_render
from tinynerf_tpu_torch.kernels import fused_train
from tinynerf_tpu_torch.kernels.fused_render import pack_weights
from tinynerf_tpu_torch.kernels.fused_train import (
    fused_loss_grads,
    fused_loss_grads_plain,
    grad_layout,
    make_fused_grad_fn,
)
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.training import TrainSettings


def _case(R=64, S=16, L=4, hidden=32, depth=4, skip_at=2, seed=0, jdt=jnp.float32):
    jcfg = JaxConfig(in_dim=encoding_dim(L), hidden=hidden, depth=depth, skip_at=skip_at,
                     compute_dtype=jdt)
    params = init_tinynerf(jax.random.PRNGKey(seed), jcfg)
    tdt = torch.float32 if jdt == jnp.float32 else torch.bfloat16
    cfg = TinyNeRFConfig(in_dim=jcfg.in_dim, hidden=hidden, depth=depth, skip_at=skip_at,
                         compute_dtype=tdt)
    model = TinyNeRF(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    target = rng.rand(R, 3).astype(np.float32)
    return params, jcfg, model, cfg, ro, rd, target


def _jax_ref(params, jcfg, ro, rd, target, S, L, white_bkgd=True, noise=None):
    """Unfused deterministic-z loss and its gradient (JAX layout)."""
    def loss(p):
        z, pts = jax_stratified(2.0, 6.0, S, jnp.asarray(ro), jnp.asarray(rd), randomized=False)
        xenc = jax_encoding(pts.reshape(-1, 3), num_freqs=L)
        sn = None if noise is None else jnp.asarray(noise).reshape(-1, 1)
        rgb, sigma = apply_tinynerf(p, xenc, jcfg, sigma_noise=sn)
        R = ro.shape[0]
        comp, _, _, _ = jax_volume_render(rgb.reshape(R, S, 3), sigma.reshape(R, S), z,
                                          jnp.asarray(rd), white_bkgd=white_bkgd)
        return jnp.mean((comp - jnp.asarray(target)) ** 2)

    return jax.value_and_grad(loss)(params)


def _port(model, cfg, ro, rd, target, S, L, **kw):
    loss, grads = fused_loss_grads_plain(
        model, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(target), 0,
        n_samples=S, num_freqs=L, randomized=False, model_cfg=cfg, **kw)
    named = {n: g for (n, _), g in zip(model.named_parameters(), grads)}
    return float(loss), state_to_jax(named)


def _leaves(tree):
    return [np.asarray(x, dtype=np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _assert_grads_close(ref, got):
    for a, b in zip(_leaves(ref), _leaves(got)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=2e-4 * float(np.abs(a).max()) + 1e-8)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_plain_matches_jax_grad_f32(white_bkgd):
    params, jcfg, model, cfg, ro, rd, target = _case()
    ref_loss, ref_grads = _jax_ref(params, jcfg, ro, rd, target, 16, 4, white_bkgd)
    loss, grads = _port(model, cfg, ro, rd, target, 16, 4, white_bkgd=white_bkgd)
    np.testing.assert_allclose(loss, float(ref_loss), atol=1e-6)
    _assert_grads_close(ref_grads, grads)


def test_plain_matches_jax_grad_nondefault_arch():
    """depth 3, skip_at 1, hidden 48."""
    params, jcfg, model, cfg, ro, rd, target = _case(R=32, S=8, L=3, hidden=48, depth=3,
                                                     skip_at=1, seed=2)
    ref_loss, ref_grads = _jax_ref(params, jcfg, ro, rd, target, 8, 3)
    loss, grads = _port(model, cfg, ro, rd, target, 8, 3)
    np.testing.assert_allclose(loss, float(ref_loss), atol=1e-6)
    _assert_grads_close(ref_grads, grads)


def test_plain_matches_jax_grad_bf16():
    """bf16 rounds at other places in the two frameworks: the JAX
    package's bf16 gradient gates (bench.py:530-544, 714)."""
    params, jcfg, model, cfg, ro, rd, target = _case(seed=3, jdt=jnp.bfloat16)
    ref_loss, ref_grads = _jax_ref(params, jcfg, ro, rd, target, 16, 4)
    loss, grads = _port(model, cfg, ro, rd, target, 16, 4)
    assert abs(loss - float(ref_loss)) / float(ref_loss) < 1e-3
    cos = [float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
           for a, b in zip(_leaves(ref_grads), _leaves(grads))]
    assert min(cos) > 0.98, cos


def test_plain_matches_jax_grad_sigma_noise():
    params, jcfg, model, cfg, ro, rd, target = _case(seed=4)
    noise = np.random.RandomState(9).randn(64, 16).astype(np.float32)
    ref_loss, ref_grads = _jax_ref(params, jcfg, ro, rd, target, 16, 4, noise=noise)
    loss, grads = _port(model, cfg, ro, rd, target, 16, 4, sigma_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(loss, float(ref_loss), atol=1e-6)
    _assert_grads_close(ref_grads, grads)


def test_jitter_stays_in_the_reference_bins(monkeypatch):
    """z enters the plain version only through pts = o + d z: with a zero
    origin and unit-x directions the encoding's first column is z."""
    _, _, model, cfg, _, _, target = _case(R=8, S=16)
    seen = []
    encode = fused_train.positional_encoding
    monkeypatch.setattr(fused_train, "positional_encoding",
                        lambda pts, num_freqs: seen.append(pts) or encode(pts, num_freqs))
    d = torch.zeros(8, 3)
    d[:, 0] = 1.0
    fused_loss_grads_plain(model, torch.zeros(8, 3), d, torch.from_numpy(target), 5,
                           n_samples=16, num_freqs=4, randomized=True, model_cfg=cfg)
    z = seen[0][:, 0].reshape(8, 16).numpy()
    h = 4.0 / 15
    grid = 2.0 + h * np.arange(16)
    lower = np.where(np.arange(16) == 0, grid, grid - h / 2)
    upper = np.where(np.arange(16) == 15, grid, grid + h / 2)
    assert np.all(z >= lower - 1e-6) and np.all(z <= upper + 1e-6)
    assert np.std(z - grid) > 0.01  # jittered


def test_wrapper_takes_plain_version_on_cpu_and_checks_the_tile():
    _, _, model, cfg, ro, rd, target = _case()
    t = [torch.from_numpy(x) for x in (ro, rd, target)]
    before = fused_loss_grads.launches
    loss, grads = fused_loss_grads(model, *t, 7, n_samples=16, num_freqs=4, model_cfg=cfg)
    want_loss, want = fused_loss_grads_plain(model, *t, 7, n_samples=16, num_freqs=4, model_cfg=cfg)
    assert fused_loss_grads.launches == before
    assert float(loss) == float(want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    # A batch off the ray tile (4 rays at S=16) is taken: the card pads it
    # to whole tiles with rays that add nothing; the CPU needs no padding.
    loss, grads = fused_loss_grads(model, *(x[:62] for x in t), 7, n_samples=16, num_freqs=4,
                                   model_cfg=cfg)
    want_loss, want = fused_loss_grads_plain(model, *(x[:62] for x in t), 7, n_samples=16,
                                             num_freqs=4, model_cfg=cfg)
    assert float(loss) == float(want_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    with pytest.raises(ValueError, match="n_rand must be positive"):
        fused_loss_grads(model, *(x[:0] for x in t), 7, n_samples=16, num_freqs=4, model_cfg=cfg)


def test_grad_fn_writes_param_grads():
    _, _, model, cfg, ro, rd, target = _case()
    s = TrainSettings(n_rand=64, n_samples=16, num_freqs=4, sigma_noise_std=0.5, model_cfg=cfg)
    grad_fn = make_fused_grad_fn(s)
    t = [torch.from_numpy(x) for x in (ro, rd, target)]
    loss, metrics = grad_fn(model, *t, torch.Generator().manual_seed(1))
    assert torch.isfinite(loss) and float(metrics["psnr"]) == pytest.approx(-10 * np.log10(float(loss)))
    for p in model.parameters():
        assert p.grad is not None and p.grad.shape == p.shape
    grads = [p.grad.clone() for p in model.parameters()]
    grad_fn(model, *t, torch.Generator().manual_seed(1))  # same generator seed: same step
    assert all(torch.equal(a, p.grad) for a, p in zip(grads, model.parameters()))


@pytest.mark.parametrize("depth,skip_at", [(4, 2), (3, 1), (2, 0)])
def test_grad_layout_is_pack_weights_layout(depth, skip_at):
    """The kernel writes its gradients in pack_weights' layout; the index
    map sends each entry to its parameter's own (out, in) position."""
    cfg = TinyNeRFConfig(in_dim=27, hidden=16, depth=depth, skip_at=skip_at,
                         compute_dtype=torch.float32)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(0))
    packed = pack_weights(model, cfg)
    layout = grad_layout(cfg)
    assert sum(v.numel() for v in layout.values()) == packed.numel()
    seen = torch.cat([v.reshape(-1) for v in layout.values()])
    assert torch.equal(seen.sort().values, torch.arange(packed.numel()))
    for name, p in model.named_parameters():
        assert torch.equal(packed[layout[name]], p.detach())
