"""Port parity for the full NeRF's training slice on the CPU.

The eager hierarchical loss, the plain versions of K4
(fused_nerf_pass_grads) and K6 (fused_nerf_pass_grads_streamed) - the
wrappers' CPU paths - and the whole fused step against the JAX package:
once each against the Pallas kernel in interpret mode, as
tests/test_fused_nerf_train.py and tests/test_fused_nerf_stream.py run
it, otherwise against jax.value_and_grad of the unfused functions. The
CUDA kernels themselves are compared with the plain versions on the card
by tests/test_torch_port_cuda.py and chip_smoke.py.

The JAX tests' TINY config, f32. Tolerances are the JAX package's own:
loss atol 1e-6, gradients 3e-4 of each leaf's max
(tests/test_fused_nerf_train.py:48-77); K6 against K4 1e-6 relative and
1e-5 of each leaf's max (tests/test_fused_nerf_stream.py:117-128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.kernels import fused_nerf_stream as jstream
from tinynerf_tpu.kernels import fused_nerf_train as jtrain
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu.ops.sampling import stratified_samples as jstrat
from tinynerf_tpu.ops.volume import volume_render as jvolume
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
    fused_nerf_pass_grads_streamed,
    fused_nerf_pass_grads_streamed_plain,
)
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    fine_pass_route,
    fused_nerf_pass_grads,
    fused_nerf_pass_grads_plain,
    grad_layout,
    make_fused_nerf_grad_fn,
    pack_backward_weights,
    scatter_index,
)
from tinynerf_tpu_torch.kernels.fused_nerf import pack_nerf_weights
from tinynerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    make_hierarchical_loss,
    nerf_params_from_jax,
    nerf_state_to_jax,
    render_rays_hierarchical,
)
from tinynerf_tpu_torch.training import TrainSettings, make_train_block, init_train_state, step_generator

TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def pair(seed, **kw):
    """A JAX {'coarse', 'fine'} tree and the port's NeRF with the same weights (f32)."""
    over = {**TINY, **kw}
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **over)
    tcfg = NeRFConfig(compute_dtype=torch.float32, **over)
    params = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf(jax.random.PRNGKey(seed), jcfg))
    model = NeRF(tcfg)
    model.load_state_dict(nerf_params_from_jax(params))
    return params, jcfg, model, tcfg


def batch(R, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    target = rng.rand(R, 3).astype(np.float32)
    return ro, rd, target


def sorted_z(R, S, seed):
    rng = np.random.RandomState(seed)
    return np.sort(rng.uniform(2.0, 6.0, (R, S)).astype(np.float32), axis=1)


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def mlp_grads_to_jax(mlp, grads):
    """Gradients aligned to mlp.parameters() -> one MLP's JAX tree."""
    tree = nerf_state_to_jax({f"coarse.{n}": g for (n, _), g in zip(mlp.named_parameters(), grads)}
                             | {f"fine.{n}": g for (n, _), g in zip(mlp.named_parameters(), grads)})
    return tree["coarse"]


def model_grads_to_jax(model):
    return nerf_state_to_jax({n: p.grad for n, p in model.named_parameters()})


def assert_close(ref, got, rtol=3e-4):
    flat_r, tr = jax.tree_util.tree_flatten(ref)
    flat_g, tg = jax.tree_util.tree_flatten(got)
    assert str(tr) == str(tg)
    for a, b in zip(flat_r, flat_g):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=rtol * max(1e-6, float(np.abs(a).max())) + 1e-8)


def jax_hier_loss(params, ro, rd, target, n_coarse, n_fine, cfg):
    """tests/test_fused_nerf_train.py:38-45."""
    comp_c, comp_f = jnerf.render_rays_hierarchical(
        params, jnp.asarray(ro), jnp.asarray(rd), n_coarse=n_coarse, n_fine=n_fine, cfg=cfg,
        randomized=False)
    tg = jnp.asarray(target)
    return jnp.mean((comp_c - tg) ** 2) + jnp.mean((comp_f - tg) ** 2)


def jax_pass_loss(mlp, ro, rd, target, z, cfg, noise=None, white_bkgd=True):
    """One unfused pass over depths z (tests/test_fused_nerf_stream.py:37-52)."""
    R, S = z.shape
    ro, rd, z = jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(z)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x = jenc(pts.reshape(-1, 3), num_freqs=cfg.num_freqs)
    d_enc = None
    if cfg.use_viewdirs:
        vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        d_enc = jnp.repeat(jenc(vd, num_freqs=cfg.num_freqs_dir), S, axis=0)
    sn = None if noise is None else jnp.asarray(noise).reshape(-1, 1)
    rgb, sig = jnerf.apply_nerf_mlp(mlp, x, d_enc, cfg, sigma_noise=sn)
    comp, _, _, _ = jvolume(rgb.reshape(R, S, 3), sig.reshape(R, S), z, rd, white_bkgd=white_bkgd)
    return jnp.mean((comp - jnp.asarray(target)) ** 2)


# 1. The eager loss.


def test_eager_hierarchical_loss_matches_jax_grad():
    params, jcfg, model, tcfg = pair(0)
    ro, rd, target = batch(32, 0)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_hier_loss(p, ro, rd, target, 8, 8, jcfg))(params)
    comp_c, comp_f = render_rays_hierarchical(model, *t(ro, rd), n_coarse=8, n_fine=8, cfg=tcfg)
    tg = torch.from_numpy(target)
    loss = torch.mean((comp_c - tg) ** 2) + torch.mean((comp_f - tg) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=1e-6)
    assert_close(ref_grads, model_grads_to_jax(model))


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_plain_pass_with_sigma_noise_matches_jax_grad(white_bkgd):
    """Explicit noise arrays into both apply_nerf_mlps, given depths."""
    params, jcfg, model, tcfg = pair(1)
    ro, rd, target = batch(32, 1)
    z = sorted_z(32, 12, 1)
    noise = np.random.RandomState(2).randn(32, 12).astype(np.float32)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda m: jax_pass_loss(m, ro, rd, target, z, jcfg, noise, white_bkgd))(params["coarse"])
    loss, grads = fused_nerf_pass_grads_plain(
        model.coarse, *t(ro, rd, target), 0, torch.from_numpy(z), randomized=False,
        sigma_noise=torch.from_numpy(noise), white_bkgd=white_bkgd, cfg=tcfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    assert_close(ref_grads, mlp_grads_to_jax(model.coarse, grads))


# 2. K4's plain version.


def test_k4_plain_matches_pallas_kernel_interpret():
    """tests/test_fused_nerf_train.py:80-110: randomized=False,
    emit_sampling=True, tile_r=32, against the Pallas kernel itself."""
    params, jcfg, model, tcfg = pair(2)
    ro, rd, target = batch(32, 2)
    jl, jg, jw, jz = jtrain.fused_nerf_pass_grads(
        params["coarse"], *map(jnp.asarray, (ro, rd, target)), 0, n_samples=8, randomized=False,
        emit_sampling=True, cfg=jcfg, tile_r=32, interpret=True)
    loss, grads, w, z = fused_nerf_pass_grads_plain(
        model.coarse, *t(ro, rd, target), 0, n_samples=8, randomized=False, emit_sampling=True,
        cfg=tcfg)
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-6)
    assert_close(jg, mlp_grads_to_jax(model.coarse, grads))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(use_viewdirs=False), dict(depth=4, skip_at=1)])
def test_k4_plain_matches_jax_grad_other_configs(kw):
    """tests/test_fused_nerf_train.py:62-90 (no viewdirs), and another
    skip placement, against jax.grad of the unfused pass on the grid."""
    params, jcfg, model, tcfg = pair(3, **kw)
    ro, rd, target = batch(32, 3)
    R, S = 32, 8

    def ref(m):
        z, _ = jstrat(2.0, 6.0, S, jnp.asarray(ro), jnp.asarray(rd), randomized=False)
        return jax_pass_loss(m, ro, rd, target, np.asarray(z), jcfg)

    ref_loss, ref_grads = jax.value_and_grad(ref)(params["fine"])
    loss, grads = fused_nerf_pass_grads_plain(model.fine, *t(ro, rd, target), 0, n_samples=S,
                                              randomized=False, cfg=tcfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    assert_close(ref_grads, mlp_grads_to_jax(model.fine, grads))


def test_k4_wrapper_takes_plain_version_on_cpu():
    _, _, model, tcfg = pair(4)
    ro, rd, target = t(*batch(16, 4))
    before = fused_nerf_pass_grads.launches
    got = fused_nerf_pass_grads(model.coarse, ro, rd, target, 9, n_samples=8, emit_sampling=True,
                                cfg=tcfg)
    want = fused_nerf_pass_grads_plain(model.coarse, ro, rd, target, 9, n_samples=8,
                                       emit_sampling=True, cfg=tcfg)
    assert fused_nerf_pass_grads.launches == before
    assert float(got[0]) == float(want[0]) and torch.equal(got[3], want[3])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    with pytest.raises(ValueError, match="at least 2 samples"):
        fused_nerf_pass_grads(model.coarse, ro, rd, target, 9, n_samples=1, cfg=tcfg)


# 3. K6's plain version.


@pytest.mark.parametrize("noise", [False, True])
def test_k6_plain_matches_pallas_kernel_interpret(noise):
    params, jcfg, model, tcfg = pair(5)
    ro, rd, target = batch(32, 5)
    z = sorted_z(32, 16, 5)
    sn = np.random.RandomState(6).randn(32, 16).astype(np.float32) if noise else None
    jl, jg = jstream.fused_nerf_pass_grads_streamed(
        params["fine"], *map(jnp.asarray, (ro, rd, target, z)), cfg=jcfg, tile_r=16,
        sample_block=4, interpret=True, sigma_noise=None if sn is None else jnp.asarray(sn))
    loss, grads = fused_nerf_pass_grads_streamed_plain(
        model.fine, *t(ro, rd, target, z), cfg=tcfg, sample_block=4,
        sigma_noise=None if sn is None else torch.from_numpy(sn))
    np.testing.assert_allclose(float(loss), float(jl), atol=1e-6)
    assert_close(jg, mlp_grads_to_jax(model.fine, grads))


@pytest.mark.parametrize("sample_block", [4, 8, 24])
def test_k6_plain_matches_k4_plain_on_one_union(sample_block):
    _, _, model, tcfg = pair(6)
    ro, rd, target, z = t(*batch(32, 6), sorted_z(32, 24, 6))
    l4, g4 = fused_nerf_pass_grads_plain(model.fine, ro, rd, target, 0, z, randomized=False,
                                         cfg=tcfg)
    l6, g6 = fused_nerf_pass_grads_streamed(model.fine, ro, rd, target, z, cfg=tcfg,
                                            sample_block=sample_block)
    assert abs(float(l6) - float(l4)) <= 1e-6 * float(l4)
    for a, b in zip(g6, g4):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-9
    with pytest.raises(ValueError, match="multiple of sample_block"):
        fused_nerf_pass_grads_streamed(model.fine, ro, rd, target, z, cfg=tcfg, sample_block=5)


# 4. The whole step.


@pytest.mark.parametrize("sample_block", [None, 4])
def test_fused_grad_fn_matches_jax_grad_of_hierarchical_loss(sample_block):
    """tests/test_fused_nerf_train.py:59-77 (fine pass monolithic) and
    tests/test_fused_nerf_stream.py:148-185 (streamed, block 4)."""
    params, jcfg, model, tcfg = pair(7)
    ro, rd, target = batch(32, 7)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_hier_loss(p, ro, rd, target, 8, 8, jcfg))(params)
    s = TrainSettings(n_rand=32, n_samples=8, num_freqs=4)
    grad_fn = make_fused_nerf_grad_fn(s, tcfg, n_fine=8, randomized=False,
                                      sample_block=sample_block)
    loss_f, metrics = grad_fn(model, *t(ro, rd, target), torch.Generator())
    np.testing.assert_allclose(float(metrics["loss_coarse"]) + float(loss_f), float(ref_loss),
                               atol=1e-6)
    assert float(metrics["psnr"]) == pytest.approx(-10 * np.log10(float(loss_f)))
    assert_close(ref_grads, model_grads_to_jax(model))


# 5. Routing.


def jax_route(hidden, n_fine, bf16, sample_block):
    """The fine pass's kernel by the JAX package's own rule, read from its
    grad_fn's closure: the sample block of the streamed kernel, or None."""
    jcfg = jnerf.NeRFConfig(hidden=hidden, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    fn = jtrain.make_fused_nerf_grad_fn(JaxSettings(n_rand=2048, n_samples=64), jcfg,
                                        n_fine=n_fine, randomized=False, interpret=True,
                                        sample_block=sample_block)
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["fine_block"].cell_contents if cells["stream_fine"].cell_contents else None


@pytest.mark.parametrize("hidden,n_fine,bf16,sample_block,want", [
    (256, 128, True, None, 64),    # the flagship: 100.7 MB -> K6, block 64
    (128, 64, True, None, None),   # the default --model nerf width: 33.6 MB -> K4
    (128, 128, True, None, None),  # union 192: 50.3 MB -> K4
    (128, 448, True, None, 64),    # the --n-fine 448 recipe: 134 MB -> K6
    (128, 64, False, None, 64),    # f32 at the default width: 67.1 MB -> K6
    (32, 8, True, 4, 4),           # an explicit block always streams
])
def test_fine_pass_routing_is_the_jax_rule(hidden, n_fine, bf16, sample_block, want):
    cfg = NeRFConfig(hidden=hidden, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    s = TrainSettings(n_rand=2048, n_samples=64)
    assert fine_pass_route(s, cfg, n_fine, sample_block=sample_block) == want
    assert jax_route(hidden, n_fine, bf16, sample_block) == want


# 6. Randomized draws.


def test_randomized_draws_replay_and_stay_in_bins(monkeypatch):
    from tinynerf_tpu_torch.kernels import fused_nerf_train as ktrain

    _, _, model, tcfg = pair(8)
    ro, rd, target = t(*batch(16, 8))
    seen = []
    orig = ktrain.sample_pdf

    def spy(bins, *a, **k):
        seen.append((bins, orig(bins, *a, **k)))
        return seen[-1][1]

    monkeypatch.setattr(ktrain, "sample_pdf", spy)
    s = TrainSettings(n_rand=16, n_samples=8, num_freqs=4, sigma_noise_std=0.5)
    grad_fn = make_fused_nerf_grad_fn(s, tcfg, n_fine=8)
    runs = []
    for step in (3, 3, 4):
        loss, _ = grad_fn(model, ro, rd, target, step_generator(0, step, "cpu"))
        runs.append((float(loss), [p.grad.clone() for p in model.parameters()], seen[-1][1]))
    # The same (seed, step) replays bit-identically; another step differs.
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0] and not torch.equal(runs[0][2], runs[2][2])
    # sample_pdf's u lie in [0, 1): the fine samples stay between the
    # first and last coarse midpoints, and they are random (not the
    # deterministic linspace u).
    for bins, zf in seen:
        assert bool(((zf >= bins[:, :1]) & (zf <= bins[:, -1:])).all())
    det = orig(seen[0][0], torch.full((16, 6), 1.0 / 6), 8, randomized=False)
    assert not torch.equal(seen[0][1], det)
    # The coarse depths of the plain K4 lie in their bins.
    _, _, _, z = fused_nerf_pass_grads_plain(model.coarse, ro, rd, target, 11, n_samples=8,
                                             emit_sampling=True, cfg=tcfg)
    h = 4.0 / 7
    grid = 2.0 + h * torch.arange(8)
    lower = torch.where(torch.arange(8) == 0, grid, grid - h / 2)
    upper = torch.where(torch.arange(8) == 7, grid, grid + h / 2)
    assert bool(((z >= lower - 1e-6) & (z <= upper + 1e-6)).all()) and float((z - grid).std()) > 0.01


def test_hierarchical_loss_draws_in_order_and_replays():
    _, _, model, tcfg = pair(9)
    ro, rd, target = t(*batch(16, 9))
    s = TrainSettings(n_rand=16, n_samples=8, num_freqs=4, sigma_noise_std=1.0)
    loss = make_hierarchical_loss(tcfg, n_fine=8)
    a = loss(model, ro, rd, target, step_generator(0, 5, "cpu"), s)
    b = loss(model, ro, rd, target, step_generator(0, 5, "cpu"), s)
    c = loss(model, ro, rd, target, step_generator(0, 6, "cpu"), s, noise_scale=0.0)
    assert float(a[0]) == float(b[0]) and float(a[0]) != float(c[0])
    assert set(a[1]) == {"loss", "psnr", "loss_coarse"}
    assert float(a[0]) == pytest.approx(float(a[1]["loss"]) + float(a[1]["loss_coarse"]), rel=1e-6)
    with pytest.raises(ValueError, match="generator"):
        render_rays_hierarchical(model, ro, rd, cfg=tcfg, randomized=True)


# 9. Learning.


def test_fused_nerf_training_learns():
    """tests/test_fused_nerf_train.py:112-130: three blocks of 15 steps."""
    _, _, _, tcfg = pair(10)
    ro, rd, target = t(*batch(64, 1))
    s = TrainSettings(n_rand=64, n_samples=8, num_freqs=4)
    grad_fn = make_fused_nerf_grad_fn(s, tcfg, n_fine=8, randomized=False)
    block = make_train_block(s, 15, grad_fn=grad_fn)
    model, opt = init_train_state(torch.Generator().manual_seed(0), s,
                                  init_fn=lambda g, dev: NeRF(tcfg, generator=g, device=dev))
    losses = []
    for b in range(3):
        m = block(model, opt, 2, b * 15, ro[None], rd[None], target[None])
        assert set(m) == {"loss", "psnr", "loss_coarse"} and m["loss"].shape == (15,)
        losses.append(float(m["loss"].mean()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# The gradient layout.


@pytest.mark.parametrize("kw", [dict(), dict(use_viewdirs=False), dict(depth=2, skip_at=0)])
def test_grad_layout_is_pack_nerf_weights_layout(kw):
    """The kernel writes its gradients in pack_nerf_weights' layout; the
    scatter index sends each entry to its parameter's own (out, in)
    position and skips the padding."""
    cfg = NeRFConfig(compute_dtype=torch.float32, **{**TINY, **kw})
    mlp = NeRF(cfg, generator=torch.Generator().manual_seed(0)).coarse
    packed = pack_nerf_weights(mlp, cfg)
    layout = grad_layout(cfg)
    for name, p in mlp.named_parameters():
        assert torch.equal(packed[layout[name]], p.detach()), name
    dst = scatter_index(tuple(n for n, _ in mlp.named_parameters()), cfg, torch.device("cpu"))
    n = sum(p.numel() for p in mlp.parameters())
    assert dst.numel() == packed.numel() + 1 and int((dst < 0).sum()) == 3 and int(dst[-1]) == n
    flat = torch.cat([p.detach().reshape(-1) for p in mlp.parameters()])
    keep = dst[:-1] >= 0
    assert torch.equal(flat[dst[:-1][keep].long()], packed[keep])
    wb = pack_backward_weights(mlp, cfg)
    assert wb.numel() == (cfg.depth - 1) * cfg.hidden ** 2 + cfg.rgb_hidden * cfg.hidden
