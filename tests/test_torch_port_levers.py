"""The flagship training levers of the port against the JAX package on the
CPU, on identical seeded numpy inputs at small sizes: the sigma-noise
schedule, the lr schedule, Adam/AdamW with the schedule and the EMA over
20 steps, their checkpoints (optax's state trees, resumes across the
packages both ways), the sigma-death watchdog and the background PSNR,
the precrop window and the pool and precrop draws, and the strided
holdout. No Pallas, no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from tinynerf_tpu import training as jtraining
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import init_tinynerf
from tinynerf_tpu.utils import checkpoint as jax_ckpt
from tinynerf_tpu_torch import train as train_mod
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_to_jax
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.training import (
    SigmaDeathDetector,
    TrainSettings,
    background_psnr,
    draw_ray_batch,
    exponential_lr,
    make_optimizer,
    noise_scale,
    precrop_pixels,
    precrop_window,
    step_generator,
)
from tinynerf_tpu_torch.utils import checkpoint

HID = 16
LR = 5e-4
# (decay_steps, decay_factor, weight_decay, lr_floor, ema_decay): plain
# Adam, + the lr schedule, + AdamW, and all four levers with the EMA.
OPTIONS = {
    "adam": dict(),
    "schedule": dict(decay_steps=8, decay_factor=0.1, lr_floor=1e-4),
    "adamw": dict(weight_decay=1e-2),
    "all": dict(decay_steps=8, decay_factor=0.1, lr_floor=1e-4, weight_decay=1e-2,
                ema_decay=0.9),
}


def _pair(seed=0):
    jcfg = JaxConfig(in_dim=27, hidden=HID, depth=3, skip_at=2, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, init_tinynerf(jax.random.PRNGKey(seed), jcfg))
    model = TinyNeRF(TinyNeRFConfig(in_dim=27, hidden=HID, depth=3, skip_at=2,
                                    compute_dtype=torch.float32))
    model.load_state_dict(params_from_jax(params))
    return params, model


def _grads(params, k):
    rng = np.random.RandomState(100 + k)
    return jax.tree_util.tree_map(lambda x: (rng.randn(*x.shape) * 1e-2).astype(np.float32),
                                  params)


def _jax_steps(tx, params, state, ks):
    for k in ks:
        updates, state = tx.update(_grads(params, k), state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _port_steps(model, opt, ks):
    named = dict(model.named_parameters())
    for k in ks:
        for name, g in params_from_jax(_grads(state_to_jax(model.state_dict()), k)).items():
            named[name].grad = g.clone()
        opt.step()


def _port_leaves(model, tensors=None):
    names = [n for n, _ in model.named_parameters()]
    tensors = tensors if tensors is not None else [p.detach() for p in model.parameters()]
    return checkpoint._flatten(state_to_jax(dict(zip(names, tensors))))


def _close(port_leaves, jax_leaves):
    assert len(port_leaves) == len(jax_leaves)
    for a, b in zip(port_leaves, jax_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7)


def _tx(o):
    return jtraining.make_optimizer(LR, o.get("decay_steps", 0), o.get("decay_factor", 0.1),
                                    weight_decay=o.get("weight_decay", 0.0),
                                    lr_floor=o.get("lr_floor", 0.0),
                                    ema_decay=o.get("ema_decay", 0.0))


@pytest.mark.parametrize("floor", [0.0, 0.1])
def test_noise_scale_matches_jax_exactly(floor):
    d = 40
    s = TrainSettings(sigma_noise_std=1.0, sigma_noise_decay_steps=d, sigma_noise_floor=floor)
    js = jtraining.TrainSettings(sigma_noise_std=1.0, sigma_noise_decay_steps=d,
                                 sigma_noise_floor=floor)
    for step in (0, d // 2, d, 3 * d, 7):
        want = np.float32(jtraining.noise_scale_kwargs(js, step)["noise_scale"])
        assert np.float32(noise_scale(s, step)) == want
    # Decay off: 1.0, and the JAX package passes nothing.
    assert noise_scale(TrainSettings(sigma_noise_std=1.0), 5) == 1.0
    assert jtraining.noise_scale_kwargs(jtraining.TrainSettings(sigma_noise_std=1.0), 5) == {}


@pytest.mark.parametrize("floor", [0.0, 2e-4])
def test_lr_schedule_matches_optax(floor):
    d = 20
    sched = optax.exponential_decay(init_value=LR, transition_steps=d, decay_rate=0.1,
                                    end_value=floor if floor > 0 else None)
    for count in (0, 1, d // 2, d, 3 * d):
        want = float(sched(count))
        assert abs(exponential_lr(LR, count, d, 0.1, floor) - want) <= 1e-6 * want


@pytest.mark.parametrize("name", list(OPTIONS))
def test_optimizer_20_steps_match_jax(name):
    """Every leaf, and with the EMA every EMA leaf, after 20 steps on the
    same seeded gradients; the lr the last step used is the schedule's."""
    o = OPTIONS[name]
    params, model = _pair(3)
    tx = _tx(o)
    jp, state = _jax_steps(tx, params, tx.init(params), range(20))
    opt = make_optimizer(model.parameters(), LR, **o)
    _port_steps(model, opt, range(20))
    _close(_port_leaves(model), jax.tree_util.tree_leaves(jp))
    if o.get("ema_decay"):
        _close(_port_leaves(model, opt.ema),
               jax.tree_util.tree_leaves(jtraining.ema_params_from_opt_state(state)))
    assert opt.count() == 20
    assert opt.param_groups[0]["lr"] == exponential_lr(LR, 19, o.get("decay_steps", 0),
                                                       o.get("decay_factor", 0.1),
                                                       o.get("lr_floor", 0.0))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_optimizer_state_tree_matches_jax(name):
    o = OPTIONS[name]
    params, model = _pair(0)
    state = _tx(o).init(params)
    want = str(jax.tree_util.tree_structure(state))
    p_struct = checkpoint.tree_struct(state_to_jax(model.state_dict()))
    assert checkpoint.optax_struct(p_struct, o.get("decay_steps", 0), o.get("weight_decay", 0.0),
                                   o.get("ema_decay", 0.0)) == want
    # The NeRF's {'coarse', 'fine'} tree as well.
    nerf = NeRF(NeRFConfig(num_freqs=2, num_freqs_dir=1, hidden=8, depth=2, skip_at=1,
                           rgb_hidden=8), generator=torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, nerf_params_to_jax(nerf))
    want = str(jax.tree_util.tree_structure(_tx(o).init(jparams)))
    assert checkpoint.optax_struct(checkpoint.tree_struct(nerf_params_to_jax(nerf)),
                                   o.get("decay_steps", 0), o.get("weight_decay", 0.0),
                                   o.get("ema_decay", 0.0)) == want


@pytest.mark.parametrize("name", list(OPTIONS))
def test_jax_checkpoint_resumes_in_port(tmp_path, name):
    """10 JAX steps, JAX save_checkpoint, port restore, 10 port steps ==
    20 JAX steps (parameters and EMA)."""
    o = OPTIONS[name]
    params, model = _pair(5)
    tx = _tx(o)
    jp10, st10 = _jax_steps(tx, params, tx.init(params), range(10))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, jp10, st10, 10, meta={"model": "tinynerf"})
    jp20, st20 = _jax_steps(tx, jp10, st10, range(10, 20))
    opt = make_optimizer(model.parameters(), LR, **o)
    step, meta = checkpoint.restore_checkpoint(path, model, opt)
    assert step == 10 and meta == {"model": "tinynerf"} and opt.count() == 10
    _port_steps(model, opt, range(10, 20))
    _close(_port_leaves(model), jax.tree_util.tree_leaves(jp20))
    if o.get("ema_decay"):
        _close(_port_leaves(model, opt.ema),
               jax.tree_util.tree_leaves(jtraining.ema_params_from_opt_state(st20)))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_port_checkpoint_resumes_in_jax(tmp_path, name):
    """10 port steps, port save_checkpoint, JAX restore_checkpoint with the
    matching JAX optimizer, 10 JAX steps == 20 port steps."""
    o = OPTIONS[name]
    params, model = _pair(6)
    opt = make_optimizer(model.parameters(), LR, **o)
    _port_steps(model, opt, range(10))
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, model, opt, 10, meta={"model": "tinynerf"})
    _port_steps(model, opt, range(10, 20))
    tx = _tx(o)
    jp, st, step, _ = jax_ckpt.restore_checkpoint(path, params, tx.init(params))
    assert step == 10
    jp, st = _jax_steps(tx, jp, st, range(10, 20))
    _close(_port_leaves(model), jax.tree_util.tree_leaves(jp))
    if o.get("ema_decay"):
        _close(_port_leaves(model, opt.ema),
               jax.tree_util.tree_leaves(jtraining.ema_params_from_opt_state(st)))


def test_restore_rejects_another_optimizer_chain(tmp_path):
    _, model = _pair(1)
    opt = make_optimizer(model.parameters(), LR, **OPTIONS["all"])
    path = str(tmp_path / "all.npz")
    checkpoint.save_checkpoint(path, model, opt, 0)
    with pytest.raises(ValueError, match="optimizer-state structure"):
        checkpoint.restore_checkpoint(path, model, make_optimizer(model.parameters(), LR))


def test_sigma_death_detector_matches_jax():
    rng = np.random.RandomState(7)
    # A run that learns, then dies (pinned near the floor), then recovers
    # briefly: runs of pinned points of several lengths.
    psnrs = np.concatenate([rng.uniform(12, 20, 60), rng.uniform(10.0, 11.4, 50),
                            rng.uniform(10, 14, 40), rng.uniform(10.0, 11.4, 50)])
    kw = dict(margin=1.0, window=20, grace=500)
    a, b = SigmaDeathDetector(10.5, **kw), jtraining.SigmaDeathDetector(10.5, **kw)
    for i, psnr in enumerate(psnrs):
        step = 50 * (i + 1)
        assert a.update(step, float(psnr)) == b.update(step, float(psnr))
        assert a.first_pinned_step == b.first_pinned_step
    assert not SigmaDeathDetector(80.0).enabled and not jtraining.SigmaDeathDetector(80.0).enabled


def test_background_psnr_matches_jax():
    px = np.random.RandomState(2).rand(3, 400, 3).astype(np.float32)
    for white in (True, False):
        want = jtraining.background_psnr(jnp.asarray(px), white_bkgd=white)
        assert abs(background_psnr(torch.from_numpy(px), white_bkgd=white) - want) < 1e-5


def _pixel_table(n_images, H, W):
    """rays_o whose first coordinate is the flat pool index of the pixel."""
    idx = np.arange(n_images * H * W, dtype=np.float32).reshape(n_images, H * W, 1)
    return np.concatenate([idx, np.zeros_like(idx), np.zeros_like(idx)], axis=-1)


@pytest.mark.parametrize("mode", ["image", "pool"])
def test_precrop_mapping_matches_jax_draw(mode):
    """The window indices JAX draws (re-derived from its keys) map through
    precrop_pixels to exactly the pixels its draw_ray_batch gathered."""
    n_images, H, W, frac, n = 3, 12, 10, 0.5, 64
    table = _pixel_table(n_images, H, W)
    js = jtraining.TrainSettings(n_rand=n, ray_sampling=mode, precrop_iters=5,
                                 precrop_frac=frac, image_hw=(H, W))
    key = jax.random.PRNGKey(4)
    step = 2
    ro, _, _, _ = jtraining.draw_ray_batch(js, key, step, jnp.asarray(table), jnp.asarray(table),
                                           jnp.asarray(table))
    got = np.asarray(ro)[:, 0].astype(np.int64)
    k_inds, _ = jax.random.split(jax.random.fold_in(key, step))
    ch, cw, _, _ = precrop_window(H, W, frac)
    kk = np.asarray(jax.random.randint(jax.random.fold_in(k_inds, 1), (n,), 0, ch * cw))
    center = precrop_pixels(torch.from_numpy(kk.astype(np.int64)), H, W, frac).numpy()
    if mode == "pool":
        inds = np.asarray(jax.random.randint(k_inds, (n,), 0, n_images * H * W))
        want = (inds // (H * W)) * (H * W) + center
    else:
        want = (step % n_images) * H * W + center
    np.testing.assert_array_equal(got, want)
    # A fixed index array: the window's corners and centre, exact.
    corners = torch.tensor([0, cw - 1, (ch - 1) * cw, ch * cw - 1])
    assert precrop_pixels(corners, H, W, frac).tolist() == [3 * W + 2, 3 * W + 6, 8 * W + 2,
                                                            8 * W + 6]


@pytest.mark.parametrize("mode", ["image", "pool"])
def test_pool_and_precrop_draws(mode):
    """In range; inside the window while step < precrop_iters, anywhere
    after; pool mode's images uniform (chi-square, p > 1e-3)."""
    n_images, H, W, n = 4, 12, 10, 4096
    table = torch.from_numpy(_pixel_table(n_images, H, W))
    s = TrainSettings(n_rand=n, ray_sampling=mode, precrop_iters=3, precrop_frac=0.5,
                      image_hw=(H, W))
    ch, cw, r0, c0 = precrop_window(H, W, 0.5)
    for step in (0, 2, 3, 9):
        ro, rd, px = draw_ray_batch(s, step_generator(1, step, "cpu"), step, table, table, table)
        idx = ro[:, 0].long()
        assert torch.equal(ro, rd) and torch.equal(ro, px)
        assert int(idx.min()) >= 0 and int(idx.max()) < n_images * H * W
        img, pix = idx // (H * W), idx % (H * W)
        row, col = pix // W, pix % W
        inside = (row >= r0) & (row < r0 + ch) & (col >= c0) & (col < c0 + cw)
        if step < 3:
            assert bool(inside.all())
        else:
            assert not bool(inside.all())
        if mode == "pool":
            counts = torch.bincount(img, minlength=n_images).numpy()
            assert stats.chisquare(counts).pvalue > 1e-3
        else:
            assert bool((img == step % n_images).all())
    # Without precrop the draw is the levers-off one: the same generator
    # stream as the reference recipe's image mode.
    plain = draw_ray_batch(TrainSettings(n_rand=n), step_generator(1, 5, "cpu"), 5, table, table,
                           table)[0]
    again = draw_ray_batch(TrainSettings(n_rand=n, precrop_iters=3, image_hw=(H, W)),
                           step_generator(1, 5, "cpu"), 5, table, table, table)[0]
    assert torch.equal(plain, again)


def test_strided_holdout_order():
    for n, count in ((106, 4), (106, 10)):
        want = np.unique(np.round(np.linspace(0, n - 1, count)).astype(int)).tolist()
        assert train_mod.strided_holdout(n, count) == want
    assert train_mod.strided_holdout(106, 4) == [0, 35, 70, 105]
    with pytest.raises(ValueError, match="collapses duplicate"):
        train_mod.strided_holdout(3, 5)


def test_levers_off_draw_is_the_reference_recipes():
    """Every lever off: the batch is n_rand indices of image step % N drawn
    first from the step's generator, nothing else drawn, as before the
    levers were ported; the noise factor is exactly 1."""
    n_images, H, W, n = 3, 12, 10, 256
    table = torch.from_numpy(_pixel_table(n_images, H, W))
    s = TrainSettings(n_rand=n)
    for step in (0, 4, 17):
        gen = step_generator(2, step, "cpu")
        got = draw_ray_batch(s, gen, step, table, table, table)[0][:, 0].long()
        ref_gen = step_generator(2, step, "cpu")
        inds = torch.randint(0, H * W, (n,), generator=ref_gen)
        assert torch.equal(got, (step % n_images) * H * W + inds)
        # The generator stands where the reference recipe's next draw starts.
        assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=ref_gen))
        assert noise_scale(TrainSettings(sigma_noise_std=0.5), step) == 1.0
