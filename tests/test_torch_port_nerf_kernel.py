"""Port parity for the fused NeRF kernel modules (K3, K5) on the CPU.

The kernels' plain versions (the wrappers' CPU paths) against the JAX
package: once each against the Pallas kernel in interpret mode, as
tests/test_fused_nerf.py and tests/test_fused_nerf_stream.py run it,
otherwise against the JAX package's plain functions. The CUDA kernels
themselves are compared with the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.

Tiny config of tests/test_fused_nerf.py:22-25, f32. Tolerances: the
JAX package's own, 5e-4 per pass and 1e-3 for the pipeline
(tests/test_fused_nerf.py:64-65, 105-106).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.kernels import fused_nerf as jfused
from tinynerf_tpu.kernels import fused_nerf_stream as jstream
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu.ops.sampling import stratified_samples as jstrat
from tinynerf_tpu.ops.volume import volume_render as jvolume
from tinynerf_tpu_torch.kernels import fused_nerf, fused_nerf_stream
from tinynerf_tpu_torch.kernels.fused_nerf import (
    check_launch,
    fused_nerf_render_rays,
    fused_nerf_render_rays_plain,
    fused_render_rays_hierarchical,
    pack_nerf_weights,
)
from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
    fused_nerf_render_rays_streamed,
    fused_nerf_render_rays_streamed_plain,
    pick_sample_block,
)
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, NeRFMLP, nerf_params_from_jax

TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)


def mlp_pair(seed, **kw):
    """A JAX MLP and the port's NeRFMLP with the same weights (f32)."""
    over = {**TINY, **kw}
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **over)
    tcfg = NeRFConfig(compute_dtype=torch.float32, **over)
    params = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf(jax.random.PRNGKey(seed), jcfg))
    model = NeRF(tcfg)
    model.load_state_dict(nerf_params_from_jax(params))
    return params, jcfg, model, tcfg


def rays(n, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.1).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    rd *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def sorted_z(n, S, seed):
    rng = np.random.RandomState(seed)
    return np.sort(rng.uniform(2.0, 6.0, (n, S)).astype(np.float32), axis=1)


def jax_unfused(mlp, ro, rd, z, cfg):
    """The JAX package's unfused pass (tests/test_fused_nerf.py:36-52)."""
    n_rays, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x_enc = jenc(pts.reshape(-1, 3), num_freqs=cfg.num_freqs)
    d_enc = None
    if cfg.use_viewdirs:
        vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        d_enc = jnp.repeat(jenc(vd, num_freqs=cfg.num_freqs_dir), S, axis=0)
    rgb, sigma = jnerf.apply_nerf_mlp(mlp, x_enc, d_enc, cfg)
    comp, _, _, w = jvolume(rgb.reshape(n_rays, S, 3), sigma.reshape(n_rays, S), z, rd)
    return np.asarray(comp), np.asarray(w)


def t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_plain_k3_matches_jax_kernel_analytic_z_with_weights():
    """The one interpret-mode run of the Pallas K3."""
    params, jcfg, model, tcfg = mlp_pair(0)
    ro, rd = rays(40, 1)
    want, want_w = jfused.fused_nerf_render_rays(
        params["coarse"], jnp.asarray(ro), jnp.asarray(rd), n_samples=16, cfg=jcfg,
        return_weights=True, tile_r=32, interpret=True)
    with torch.no_grad():
        got, got_w = fused_nerf_render_rays_plain(model.coarse, *t(ro, rd), n_samples=16, cfg=tcfg,
                                                  return_weights=True)
    assert got.shape == (40, 3) and got_w.shape == (40, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=5e-4)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_plain_k3_given_z_matches_jax_unfused(use_viewdirs):
    params, jcfg, model, tcfg = mlp_pair(1, use_viewdirs=use_viewdirs)
    ro, rd = rays(32, 2)
    z = sorted_z(32, 24, 3)
    want, want_w = jax_unfused(params["fine"], *map(jnp.asarray, (ro, rd, z)), jcfg)
    with torch.no_grad():
        got, got_w = fused_nerf_render_rays_plain(model.fine, *t(ro, rd, z), cfg=tcfg,
                                                  return_weights=True)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)
    np.testing.assert_allclose(got_w.numpy(), want_w, atol=5e-4)


def test_plain_k3_no_viewdirs_analytic_z_matches_jax_unfused():
    params, jcfg, model, tcfg = mlp_pair(2, use_viewdirs=False)
    ro, rd = rays(32, 4)
    z, _ = jstrat(2.0, 6.0, 8, jnp.asarray(ro), jnp.asarray(rd), randomized=False)
    want, _ = jax_unfused(params["coarse"], jnp.asarray(ro), jnp.asarray(rd), z, jcfg)
    with torch.no_grad():
        got = fused_nerf_render_rays_plain(model.coarse, *t(ro, rd), n_samples=8, cfg=tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_plain_k5_matches_jax_kernel():
    """The one interpret-mode run of the Pallas K5 (24 rays pad to 2x16)."""
    params, jcfg, model, tcfg = mlp_pair(3)
    ro, rd = rays(24, 5)
    z = sorted_z(24, 16, 6)
    want = jstream.fused_nerf_render_rays_streamed(
        params["fine"], *map(jnp.asarray, (ro, rd, z)), cfg=jcfg, tile_r=16, sample_block=4,
        interpret=True)
    with torch.no_grad():
        got = fused_nerf_render_rays_streamed_plain(model.fine, *t(ro, rd, z), cfg=tcfg,
                                                    sample_block=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


@pytest.mark.parametrize("sample_block", [1, 4, 8, 32])
def test_plain_k5_equals_plain_k3_on_the_same_z(sample_block):
    """The same factors in another order: f32 rounding only (1e-5, the
    JAX package's streamed-vs-monolithic tolerance)."""
    _, _, model, tcfg = mlp_pair(4)
    ro, rd = rays(20, 7)
    z = sorted_z(20, 32, 8)
    with torch.no_grad():
        mono = fused_nerf_render_rays_plain(model.fine, *t(ro, rd, z), cfg=tcfg)
        stream = fused_nerf_render_rays_streamed_plain(model.fine, *t(ro, rd, z), cfg=tcfg,
                                                       sample_block=sample_block)
    np.testing.assert_allclose(stream.numpy(), mono.numpy(), atol=1e-5)


def test_streamed_rejects_a_block_that_does_not_divide_s():
    _, _, model, tcfg = mlp_pair(0)
    ro, rd = rays(4, 0)
    with pytest.raises(ValueError, match="sample_block"):
        fused_nerf_render_rays_streamed(model.fine, *t(ro, rd, sorted_z(4, 8, 0)), cfg=tcfg,
                                        sample_block=3)


@pytest.mark.parametrize("S,cap", [(192, 64), (448, 128), (512, 64), (64, 64), (16, 64), (7, 64)])
def test_pick_sample_block_matches_jax(S, cap):
    assert pick_sample_block(S, cap) == jstream.pick_sample_block(S, cap)


def test_pick_sample_block_warns_like_jax():
    with pytest.warns(UserWarning, match="no divisor in"):
        jax_b = jstream.pick_sample_block(67)
    with pytest.warns(UserWarning, match="no divisor in"):
        assert pick_sample_block(67) == jax_b == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pick_sample_block(8, 64) == 8


def test_hierarchical_pipeline_matches_jax():
    """The fused pipeline (its plain versions on the CPU) against the
    JAX package's eager hierarchical render: 1e-3."""
    params, jcfg, model, tcfg = mlp_pair(5)
    ro, rd = rays(32, 9)
    want_c, want_f = jnerf.render_rays_hierarchical(
        params, jnp.asarray(ro), jnp.asarray(rd), n_coarse=16, n_fine=8, cfg=jcfg,
        randomized=False)
    with torch.no_grad():
        got_c, got_f = fused_render_rays_hierarchical(model, *t(ro, rd), n_coarse=16, n_fine=8,
                                                      cfg=tcfg)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-3)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)


@pytest.mark.parametrize("hidden,n_fine,sample_block,want", [
    (32, 8, None, ("k3", None)),        # 32 * 24 <= 128 * 384: the fine pass on K3
    (32, 8, 4, ("k5", 4)),              # a forced block streams
    (128, 448, None, ("k5", 64)),       # the --n-fine 448 recipe: union 512
    (256, 128, None, ("k3", None)),     # the flagship: 256 * 192 = 128 * 384
    (32, 1584, None, ("k5", 64)),       # 32 * 1600 > 128 * 384
])
def test_hierarchical_routing(monkeypatch, hidden, n_fine, sample_block, want):
    """Which plain version the fine pass takes (the rule of
    tinynerf_tpu/kernels/fused_nerf.py:326-337), shown by spies."""
    calls = []
    k3_plain = fused_nerf.fused_nerf_render_rays_plain

    def spy_k3(mlp, ro, rd, z=None, **kw):
        calls.append(("k3", z is not None))
        return k3_plain(mlp, ro, rd, z, **kw)

    def spy_k5(mlp, ro, rd, z, *, sample_block, **kw):
        calls.append(("k5", sample_block))
        return torch.zeros(ro.shape[0], 3)

    monkeypatch.setattr(fused_nerf, "fused_nerf_render_rays_plain", spy_k3)
    monkeypatch.setattr(fused_nerf_stream, "fused_nerf_render_rays_streamed_plain", spy_k5)
    cfg = NeRFConfig(**{**TINY, "hidden": hidden, "rgb_hidden": 16}, compute_dtype=torch.float32)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0))
    ro, rd = rays(2, 0)
    with torch.no_grad():
        fused_render_rays_hierarchical(model, *t(ro, rd), n_coarse=16 if hidden == 32 else 64,
                                       n_fine=n_fine, cfg=cfg, sample_block=sample_block)
    assert calls[0] == ("k3", False)  # the coarse pass, analytic z, weights out
    assert calls[1] == (want[0], True if want[0] == "k3" else want[1])


def test_wrappers_take_plain_versions_on_cpu(monkeypatch):
    _, _, model, tcfg = mlp_pair(6)
    ro, rd = rays(8, 1)
    z = sorted_z(8, 16, 2)
    monkeypatch.setattr(fused_nerf, "_lib", lambda: pytest.fail("built the kernel on the CPU"))
    with torch.no_grad():
        got = fused_nerf_render_rays(model.fine, *t(ro, rd, z), cfg=tcfg)
        want = fused_nerf_render_rays_plain(model.fine, *t(ro, rd, z), cfg=tcfg)
        assert torch.equal(got, want)
        got = fused_nerf_render_rays_streamed(model.fine, *t(ro, rd, z), cfg=tcfg, sample_block=8)
        want = fused_nerf_render_rays_streamed_plain(model.fine, *t(ro, rd, z), cfg=tcfg,
                                                     sample_block=8)
        assert torch.equal(got, want)
    assert fused_nerf_render_rays.launches == 0
    assert fused_nerf_render_rays_streamed.launches == 0


def test_check_launch_refuses_cpu_tensors():
    _, _, model, tcfg = mlp_pair(0)
    ro, rd = t(*rays(4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        check_launch(model.coarse, tcfg, ro, rd, None, 16)


def test_pack_nerf_weights_layout():
    """The packed order the kernel walks: trunk (W (in, out), b)...,
    sigma (W, b, 3 zeros), rgb_in (W, b), rgb (W, b); every matrix the
    kernel reads with 16-byte loads starts on a multiple of 4 floats."""
    for dtype in (torch.float32, torch.bfloat16):
        cfg = NeRFConfig(**TINY, compute_dtype=dtype)
        mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(0))
        buf = pack_nerf_weights(mlp, cfg)
        off = 0
        for lin in mlp.layers:
            n_in, n_out = lin.in_features, lin.out_features
            assert off % 4 == 0
            w = buf[off:off + n_in * n_out].reshape(n_in, n_out)
            assert torch.equal(w, lin.weight.detach().to(dtype).float().t())
            off += n_in * n_out
            assert torch.equal(buf[off:off + n_out], lin.bias.detach())
            off += n_out
        assert torch.equal(buf[off:off + 32], mlp.sigma.weight.detach().to(dtype).float()[0])
        assert float(buf[off + 32]) == float(mlp.sigma.bias.detach()) and bool((buf[off + 33:off + 36] == 0).all())
        off += 36
        assert off % 4 == 0
        n_in = 32 + 15
        w = buf[off:off + n_in * 16].reshape(n_in, 16)
        assert torch.equal(w, mlp.rgb_in.weight.detach().to(dtype).float().t())
        off += n_in * 16 + 16
        w = buf[off:off + 16 * 3].reshape(16, 3)
        assert torch.equal(w, mlp.rgb.weight.detach().to(dtype).float().t())
        assert off + 16 * 3 + 3 == buf.numel()
