"""Port parity for the training core: the eager loss, Adam, checkpoints
with optimizer state in both directions, the ray-batch draw, the model's
sigma-noise, and the metrics and evaluation, against the JAX package on
identical numpy inputs at small sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinynerf_tpu import evaluation as jax_evaluation
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import apply_tinynerf, init_tinynerf
from tinynerf_tpu.ops.encoding import positional_encoding as jax_encoding
from tinynerf_tpu.ops.volume import volume_render as jax_volume_render
from tinynerf_tpu.render import render_image_fn as jax_render_image_fn
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu.training import init_train_state as jax_init_train_state
from tinynerf_tpu.utils import checkpoint as jax_ckpt
from tinynerf_tpu.utils import metrics as jax_metrics
from tinynerf_tpu_torch import evaluation
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.render import make_image_renderer
from tinynerf_tpu_torch.training import (
    TrainSettings,
    draw_ray_batch,
    init_train_state,
    loss_fn,
    make_optimizer,
    make_train_block,
    step_generator,
)
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils import metrics

L, HID = 4, 32


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def _pair(seed=0, depth=4, skip_at=2):
    jcfg = JaxConfig(in_dim=27, hidden=HID, depth=depth, skip_at=skip_at, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, init_tinynerf(jax.random.PRNGKey(seed), jcfg))
    cfg = TinyNeRFConfig(in_dim=27, hidden=HID, depth=depth, skip_at=skip_at,
                         compute_dtype=torch.float32)
    model = TinyNeRF(cfg)
    model.load_state_dict(params_from_jax(params))
    return params, jcfg, model, cfg


def _rays(R, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd, rng.rand(R, 3).astype(np.float32)


def _grads_jax_layout(model):
    return state_to_jax({n: p.grad for n, p in model.named_parameters()})


def test_model_sigma_noise_matches_jax():
    params, jcfg, model, _ = _pair(1)
    x = np.random.RandomState(2).randn(50, 27).astype(np.float32)
    noise = np.random.RandomState(3).randn(50, 1).astype(np.float32)
    want_rgb, want_sigma = apply_tinynerf(params, jnp.asarray(x), jcfg, sigma_noise=jnp.asarray(noise))
    with torch.no_grad():
        rgb, sigma = model(torch.from_numpy(x), sigma_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=1e-5)
    assert (sigma.numpy() == 0).any() and (sigma.numpy() > 0).any()


@pytest.mark.parametrize("noise_std", [0.0, 0.5])
def test_eager_loss_grad_matches_jax(noise_std):
    """loss_fn's z and noise are rebuilt by replaying its generator; the
    JAX loss runs on the same z and noise."""
    params, jcfg, model, cfg = _pair(2)
    R, S = 32, 16
    ro, rd, target = _rays(R, 4)
    s = TrainSettings(n_rand=R, n_samples=S, num_freqs=L, sigma_noise_std=noise_std, model_cfg=cfg)
    loss, _ = loss_fn(model, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(target),
                      torch.Generator().manual_seed(11), s)
    loss.backward()

    gen = torch.Generator().manual_seed(11)
    noise = None
    if noise_std > 0:
        noise = noise_std * torch.randn((R * S, 1), generator=gen)
    z, _ = stratified_samples(2.0, 6.0, S, torch.from_numpy(ro), torch.from_numpy(rd),
                              randomized=True, generator=gen)

    def jloss(p):
        zj = jnp.asarray(z.numpy())
        pts = jnp.asarray(ro)[:, None] + jnp.asarray(rd)[:, None] * zj[..., None]
        xenc = jax_encoding(pts.reshape(-1, 3), num_freqs=L)
        sn = None if noise is None else jnp.asarray(noise.numpy())
        rgb, sigma = apply_tinynerf(p, xenc, jcfg, sigma_noise=sn)
        comp, _, _, _ = jax_volume_render(rgb.reshape(R, S, 3), sigma.reshape(R, S), zj,
                                          jnp.asarray(rd))
        return jnp.mean((comp - jnp.asarray(target)) ** 2)

    ref_loss, ref_grads = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(ref_grads),
                    jax.tree_util.tree_leaves(_grads_jax_layout(model))):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, atol=2e-4 * float(np.abs(a).max()) + 1e-8)


def test_adam_matches_optax():
    params, _, model, _ = _pair(3)
    opt = make_optimizer(model.parameters(), 5e-4)
    tx = optax.adam(5e-4, b1=0.9, b2=0.999, eps=1e-8)
    state = tx.init(params)
    jp = params
    rng = np.random.RandomState(5)
    for _ in range(5):
        g = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32) * 1e-2, params)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, tg in params_from_jax(g).items():
            dict(model.named_parameters())[name].grad = tg
        opt.step()
    # optax forms the bias corrections in f32 (1 - 0.999 is off by 1.3e-5
    # relative), torch in double: each update differs by ~6e-6 of its
    # size (<= lr), so 5 steps allow 5 * lr * 1e-5 absolute besides rtol.
    for a, b in zip(jax.tree_util.tree_leaves(jp), checkpoint._flatten(state_to_jax(model.state_dict()))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=5 * 5e-4 * 1e-5)


def _trained_pair(seed):
    """A port model + Adam after two identical random steps."""
    _, _, model, cfg = _pair(seed)
    opt = make_optimizer(model.parameters(), 5e-4)
    rng = np.random.RandomState(seed)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        opt.step()
    return model, opt, cfg


def _jax_templates():
    s = JaxSettings(num_freqs=L, model_cfg=JaxConfig(in_dim=27, hidden=HID, compute_dtype=jnp.float32))
    return jax_init_train_state(jax.random.PRNGKey(0), s)


def _one_more_step(model, opt, params, opt_state, seed=7):
    """Apply one identical gradient to the port and the JAX state."""
    g = jax.tree_util.tree_map(
        lambda x: np.random.RandomState(seed).randn(*x.shape).astype(np.float32), params)
    updates, _ = optax.adam(5e-4, b1=0.9, b2=0.999, eps=1e-8).update(g, opt_state, params)
    jp = optax.apply_updates(params, updates)
    named = dict(model.named_parameters())
    for name, tg in params_from_jax(g).items():
        named[name].grad = tg
    opt.step()
    for a, b in zip(jax.tree_util.tree_leaves(jp), checkpoint._flatten(state_to_jax(model.state_dict()))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-8)


def test_opt_struct_matches_jax_treedef():
    _, opt_state = _jax_templates()
    assert checkpoint.opt_struct(4) == str(jax.tree_util.tree_structure(opt_state))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    model, opt, _ = _trained_pair(4)
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, model, opt, 2, {"model": "tinynerf"})
    params_t, opt_t = _jax_templates()
    params, opt_state, step, meta = jax_ckpt.restore_checkpoint(path, params_t, opt_t)
    assert step == 2 and meta == {"model": "tinynerf"}
    adam = opt_state[0]
    assert int(adam.count) == 2
    named = dict(model.named_parameters())
    mu = state_to_jax({n: opt.state[p]["exp_avg"] for n, p in named.items()})
    nu = state_to_jax({n: opt.state[p]["exp_avg_sq"] for n, p in named.items()})
    for got, want in ((params, state_to_jax(model.state_dict())), (adam.mu, mu), (adam.nu, nu)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    _one_more_step(model, opt, params, opt_state)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    params, opt_state = _jax_templates()
    tx = optax.adam(5e-4, b1=0.9, b2=0.999, eps=1e-8)
    for k in range(3):
        g = jax.tree_util.tree_map(
            lambda x: np.random.RandomState(k).randn(*x.shape).astype(np.float32), params)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, params, opt_state, 3, meta={"model": "tinynerf"})
    _, _, model, _ = _pair(9)
    opt = make_optimizer(model.parameters(), 5e-4)
    step, meta = checkpoint.restore_checkpoint(path, model, opt)
    assert step == 3 and meta == {"model": "tinynerf"}
    named = dict(model.named_parameters())
    assert all(float(opt.state[p]["step"]) == 3.0 for p in named.values())
    mu = state_to_jax({n: opt.state[p]["exp_avg"] for n, p in named.items()})
    nu = state_to_jax({n: opt.state[p]["exp_avg_sq"] for n, p in named.items()})
    for got, want in ((state_to_jax(model.state_dict()), params), (mu, opt_state[0].mu),
                      (nu, opt_state[0].nu)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    _one_more_step(model, opt, jax.tree_util.tree_map(np.asarray, params), opt_state)


def test_restore_checkpoint_rejects_params_only(tmp_path):
    _, _, model, _ = _pair(1)
    path = str(tmp_path / "params_only.npz")
    checkpoint.save_params(path, model, 0)
    with pytest.raises(ValueError, match="optimizer-state structure"):
        checkpoint.restore_checkpoint(path, model, make_optimizer(model.parameters(), 5e-4))


def test_draw_ray_batch_image_mode():
    N, hw = 3, 40
    rng = np.random.RandomState(0)
    ro = torch.from_numpy(rng.randn(N, hw, 3).astype(np.float32))
    rd = torch.from_numpy(rng.randn(N, hw, 3).astype(np.float32))
    px = torch.from_numpy(rng.rand(N, hw, 3).astype(np.float32))
    s = TrainSettings(n_rand=16)
    for step in (0, 4, 8):
        got = draw_ray_batch(s, step_generator(3, step, "cpu"), step, ro, rd, px)
        img = step % N
        for batch, table in zip(got, (ro, rd, px)):
            assert batch.shape == (16, 3)
            assert all(bool((table[img] == row).all(-1).any()) for row in batch)
        again = draw_ray_batch(s, step_generator(3, step, "cpu"), step, ro, rd, px)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    other = draw_ray_batch(s, step_generator(3, 5, "cpu"), 8, ro, rd, px)
    assert not torch.equal(other[2], draw_ray_batch(s, step_generator(3, 8, "cpu"), 8, ro, rd, px)[2])

    # Pool mode (ported): every row comes from the pool of all images.
    pool = draw_ray_batch(TrainSettings(n_rand=4, ray_sampling="pool"),
                          step_generator(0, 0, "cpu"), 0, ro, rd, px)
    for batch, table in zip(pool, (ro, rd, px)):
        assert batch.shape == (4, 3)
        assert all(bool((table.reshape(-1, 3) == row).all(-1).any()) for row in batch)


def test_train_block_learns_and_replays():
    ro, rd, target = _rays(64, 1)
    data = [torch.from_numpy(x)[None] for x in (ro, rd, target)]
    cfg = TinyNeRFConfig(in_dim=27, hidden=HID, compute_dtype=torch.float32)
    s = TrainSettings(n_rand=64, n_samples=8, num_freqs=L, lr=5e-3, model_cfg=cfg)
    runs = []
    for _ in range(2):
        model, opt = init_train_state(torch.Generator().manual_seed(0), s)
        block = make_train_block(s, 10)
        losses = [block(model, opt, 1, 10 * b, *data)["loss"] for b in range(3)]
        runs.append(torch.cat(losses))
    assert runs[0].shape == (30,) and torch.equal(runs[0], runs[1])
    assert float(runs[0][-10:].mean()) < 0.9 * float(runs[0][:10].mean())


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(24, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(24, 20, 3), 0, 1).astype(np.float32)
    for mse in (0.0, 1e-12, 0.01, 0.3):
        np.testing.assert_allclose(float(metrics.mse2psnr(mse)),
                                   float(jax_metrics.mse2psnr(mse)), atol=1e-5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(metrics.psnr(ta, tb)),
                               float(jax_metrics.psnr(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(float(metrics.ssim(ta, tb)),
                               float(jax_metrics.ssim(jnp.asarray(a), jnp.asarray(b))), atol=1e-5)


def test_evaluate_views_matches_jax():
    params, jcfg, model, cfg = _pair(6)
    rng = np.random.RandomState(1)
    images = rng.rand(3, 16, 16, 3).astype(np.float32)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, 2, 3] = [4.0, 4.5, 5.0]
    kw = dict(H=16, W=16, focal=20.0, chunk=128, n_samples=16, num_freqs=L)
    renderer = make_image_renderer(model_cfg=cfg, **kw)
    got = evaluation.evaluate_views(renderer, model, images, torch.from_numpy(poses), [0, 2])
    want = jax_evaluation.evaluate_views(
        lambda p, pose: jax_render_image_fn(p, pose, model_cfg=jcfg, **kw),
        params, jnp.asarray(images), jnp.asarray(poses), [0, 2])
    assert set(got) == set(want)
    for k in ("psnr_mean", "psnr_min", "psnr_max", "ssim_mean"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    assert got["per_view"] == want["per_view"]
