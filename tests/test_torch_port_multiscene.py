"""Port parity for multi-scene training (multiscene.py, the scene axis of
the train kernels' wrappers, the batched checkpoint and the driver).

K = 4 scenes, hidden <= 32, R <= 64, S <= 16, f32 unless stated. Against
the JAX package:
- init: tinynerf_tpu.multiscene.init_multiscene_state's stacked params
  (TinyNeRF and NeRF) converted scene by scene into the port's stacked
  module are exact, leaf by leaf and scene by scene;
- gradients on per-scene numpy batches at deterministic depths: the
  batched plain K2 (fused_loss_grads_scenes), the batched plain K4 and K6
  (fused_nerf_pass_grads_scenes, fused_nerf_pass_grads_streamed_scenes)
  and the eager scene loop against jax.vmap of the JAX gradients the
  single-scene port tests use, with their tolerances: loss atol 1e-6,
  K2 and the eager loop 2e-4 of each leaf's max
  (tests/test_torch_port_train_kernel.py), K4/K6 3e-4
  (tests/test_torch_port_nerf_train.py);
- 10 stacked Adam (and AdamW with an lr schedule) updates from given
  gradients against jax.vmap of the JAX optimizer's update, rtol 1e-5,
  atol 1e-7;
- batched checkpoints both ways: equal tree strings, `count` (K,).
Within the port (its draws are not JAX's): a K-scene block equals K
single-scene runs on each scene's seed (atol 1e-6, as
tests/test_multiscene.py:54-88), eager and fused, TinyNeRF and NeRF; a
block learns (loss down >= 5 % over 3 blocks); the divisibility check; 2
gloo ranks bit-identical to one; the driver on the CPU.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tinynerf_tpu import multiscene as jms
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxTinyConfig
from tinynerf_tpu.models.tinynerf import apply_tinynerf
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu.training import settings_optimizer as jax_settings_optimizer
from tinynerf_tpu.utils import checkpoint as jckpt
from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed_scenes
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    fused_nerf_pass_grads_scenes,
    make_fused_nerf_grad_fn,
    make_fused_nerf_grad_fn_scenes,
)
from tinynerf_tpu_torch.kernels.fused_train import (
    fused_loss_grads_scenes,
    make_fused_grad_fn,
    make_fused_grad_fn_scenes,
)
from tinynerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    make_hierarchical_loss,
    nerf_params_from_jax,
    nerf_state_to_jax,
)
from tinynerf_tpu_torch.models.stacked import scene_module, stack_models
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.multiscene import (
    eager_scene_grads,
    init_multiscene_state,
    local_scenes,
    make_multiscene_train_block,
    scene_params,
    scene_seed,
)
from tinynerf_tpu_torch.ops.encoding import encoding_dim, positional_encoding
from tinynerf_tpu_torch.ops.sampling import stratified_samples
from tinynerf_tpu_torch.ops.volume import volume_render
from tinynerf_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from tinynerf_tpu_torch.training import (
    TrainSettings,
    init_train_state,
    make_train_block,
    settings_optimizer,
)
from tinynerf_tpu_torch.utils import checkpoint as ckpt

K = 4
L = 3
TCFG = TinyNeRFConfig(in_dim=encoding_dim(L), hidden=16, compute_dtype=torch.float32)
SMALL = TrainSettings(n_rand=32, n_samples=8, num_freqs=L, lr=5e-4, model_cfg=TCFG)
JSMALL = JaxSettings(n_rand=32, n_samples=8, num_freqs=L, lr=5e-4,
                     model_cfg=JaxTinyConfig(in_dim=encoding_dim(L), hidden=16,
                                             compute_dtype=jnp.float32))
NERF = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
NCFG = NeRFConfig(compute_dtype=torch.float32, **NERF)
JNCFG = jnerf.NeRFConfig(compute_dtype=jnp.float32, **NERF)
NERF_S = TrainSettings(n_rand=32, n_samples=8, num_freqs=4, lr=5e-4)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def scenes_data(k=K, n_images=2, hw=25, seed=0):
    """tests/test_multiscene.py:28-35: per-scene rays and pixels (k, N, hw, 3)."""
    rng = np.random.RandomState(seed)
    ro = (rng.randn(k, n_images, hw, 3) * 0.1).astype(np.float32)
    rd = rng.randn(k, n_images, hw, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    px = rng.rand(k, n_images, hw, 3).astype(np.float32)
    return [torch.from_numpy(a) for a in (ro, rd, px)]


def batches(k, R, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(k, R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(k, R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd, rng.rand(k, R, 3).astype(np.float32)


def jax_tiny_stack(seed=0):
    """JAX's init_multiscene_state params (leading K) and the port's
    stacked TinyNeRF holding them."""
    params, _ = jms.init_multiscene_state(jax.random.PRNGKey(seed), K, JSMALL)
    params = jax.tree_util.tree_map(np.asarray, params)
    models = []
    for k in range(K):
        m = TinyNeRF(TCFG)
        m.load_state_dict(params_from_jax(jms.scene_params(params, k)))
        models.append(m)
    return params, stack_models(models)


def jax_nerf_stack(seed=0):
    init = lambda key: jnerf.init_nerf(key, JNCFG)  # noqa: E731
    params, _ = jms.init_multiscene_state(jax.random.PRNGKey(seed), K, JSMALL, init_fn=init)
    params = jax.tree_util.tree_map(np.asarray, params)
    models = []
    for k in range(K):
        m = NeRF(NCFG)
        m.load_state_dict(nerf_params_from_jax(jms.scene_params(params, k)))
        models.append(m)
    return params, stack_models(models)


def leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_leaves_close(ref, got, rtol):
    for a, b in zip(leaves(ref), leaves(got)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=rtol * float(np.abs(a).max()) + 1e-8)


def stacked_grads_to_jax(model, grads, to_jax):
    """Per-scene port gradients (K, *shape) aligned to model.parameters()
    -> the JAX-layout tree with a leading K axis."""
    names = [n for n, _ in model.named_parameters()]
    trees = [to_jax({n: g[k] for n, g in zip(names, grads)}) for k in range(K)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


# 1. Init.


@pytest.mark.parametrize("kind", ["tinynerf", "nerf"])
def test_jax_init_converts_exactly_into_the_stacked_module(kind):
    params, model = (jax_tiny_stack if kind == "tinynerf" else jax_nerf_stack)()
    to_jax = state_to_jax if kind == "tinynerf" else nerf_state_to_jax
    assert all(p.shape[0] == K for p in model.parameters())
    for k in range(K):
        one = scene_params(model, k)
        assert type(one) is (TinyNeRF if kind == "tinynerf" else NeRF)
        for a, b in zip(leaves(jms.scene_params(params, k)), leaves(to_jax(one.state_dict()))):
            np.testing.assert_array_equal(a, b)
    got = stacked_grads_to_jax(model, list(model.parameters()), to_jax)
    for a, b in zip(leaves(params), leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_port_init_draws_each_scene_from_its_own_seed():
    model, opt = init_multiscene_state(3, K, SMALL)
    assert all(p.shape[0] == K for p in model.parameters())
    for k in range(K):
        one = TinyNeRF(TCFG, generator=torch.Generator().manual_seed(scene_seed(3, k)))
        assert all(torch.equal(a, b) for a, b in zip(scene_params(model, k).parameters(),
                                                     one.parameters()))
    assert not torch.equal(model.layers[0].weight[0], model.layers[0].weight[1])
    assert opt.count() == 0


# 2. Gradients against jax.vmap of the JAX gradient.


def jax_tiny_loss(p, ro, rd, target):
    """The unfused deterministic-z TinyNeRF loss (tests/test_torch_port_train_kernel.py)."""
    from tinynerf_tpu.ops.encoding import positional_encoding as jenc
    from tinynerf_tpu.ops.sampling import stratified_samples as jstrat
    from tinynerf_tpu.ops.volume import volume_render as jvol

    S = 8
    z, pts = jstrat(2.0, 6.0, S, ro, rd, randomized=False)
    rgb, sigma = apply_tinynerf(p, jenc(pts.reshape(-1, 3), num_freqs=L), JSMALL.model_cfg)
    R = ro.shape[0]
    comp, _, _, _ = jvol(rgb.reshape(R, S, 3), sigma.reshape(R, S), z, rd, white_bkgd=True)
    return jnp.mean((comp - target) ** 2)


def port_tiny_loss(model, ro, rd, target, generator, s, noise_scale=1.0):
    """The same loss in the port's ops (the eager loop's subject)."""
    z, pts = stratified_samples(s.near, s.far, s.n_samples, ro, rd, randomized=False)
    rgb, sigma = model(positional_encoding(pts.reshape(-1, 3), num_freqs=s.num_freqs), s.model_cfg)
    R = ro.shape[0]
    comp, _, _, _ = volume_render(rgb.reshape(R, s.n_samples, 3), sigma.reshape(R, s.n_samples),
                                  z, rd, white_bkgd=True)
    loss = torch.mean((comp - target) ** 2)
    return loss, {"loss": loss.detach()}


def test_batched_plain_k2_matches_vmapped_jax_grad():
    params, model = jax_tiny_stack(1)
    ro, rd, target = batches(K, 64, 2)
    ref_loss, ref = jax.vmap(jax.value_and_grad(jax_tiny_loss))(params, ro, rd, target)
    loss, grads = fused_loss_grads_scenes(model, *map(torch.from_numpy, (ro, rd, target)),
                                          [0] * K, n_samples=8, num_freqs=L, randomized=False)
    assert loss.shape == (K,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=1e-6)
    assert_leaves_close(ref, stacked_grads_to_jax(model, grads, state_to_jax), 2e-4)


def test_eager_scene_loop_matches_vmapped_jax_grad():
    params, model = jax_tiny_stack(2)
    ro, rd, target = batches(K, 64, 3)
    ref_loss, ref = jax.vmap(jax.value_and_grad(jax_tiny_loss))(params, ro, rd, target)
    model.zero_grad()
    gens = [torch.Generator().manual_seed(k) for k in range(K)]
    m = eager_scene_grads(model, port_tiny_loss, *map(torch.from_numpy, (ro, rd, target)), gens,
                          SMALL)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(ref_loss), atol=1e-6)
    got = stacked_grads_to_jax(model, [p.grad for p in model.parameters()], state_to_jax)
    assert_leaves_close(ref, got, 2e-4)


def jax_pass_loss(mlp, ro, rd, target, z):
    """One unfused NeRF pass over given depths (tests/test_torch_port_nerf_train.py)."""
    from tinynerf_tpu.ops.encoding import positional_encoding as jenc
    from tinynerf_tpu.ops.volume import volume_render as jvol

    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x = jenc(pts.reshape(-1, 3), num_freqs=JNCFG.num_freqs)
    vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    d_enc = jnp.repeat(jenc(vd, num_freqs=JNCFG.num_freqs_dir), S, axis=0)
    rgb, sig = jnerf.apply_nerf_mlp(mlp, x, d_enc, JNCFG)
    comp, _, _, _ = jvol(rgb.reshape(R, S, 3), sig.reshape(R, S), z, rd, white_bkgd=True)
    return jnp.mean((comp - target) ** 2)


@pytest.mark.parametrize("streamed", [False, True])
def test_batched_plain_k4_k6_match_vmapped_jax_grad(streamed):
    params, model = jax_nerf_stack(3)
    ro, rd, target = batches(K, 48, 4)
    z = np.sort(np.random.RandomState(5).uniform(2.0, 6.0, (K, 48, 16)).astype(np.float32), -1)
    ref_loss, ref = jax.vmap(jax.value_and_grad(jax_pass_loss))(params["coarse"], ro, rd, target,
                                                                z)
    t = [torch.from_numpy(a) for a in (ro, rd, target, z)]
    if streamed:
        loss, grads = fused_nerf_pass_grads_streamed_scenes(model.coarse, *t, cfg=NCFG,
                                                            sample_block=8)
    else:
        loss, grads = fused_nerf_pass_grads_scenes(model.coarse, *t[:3], [0] * K, t[3],
                                                   randomized=False, cfg=NCFG)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=1e-6)
    names = [n for n, _ in model.coarse.named_parameters()]
    trees = [nerf_state_to_jax({f"coarse.{n}": g[k] for n, g in zip(names, grads)})["coarse"]
             for k in range(K)]
    got = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)
    assert_leaves_close(ref, got, 3e-4)


def test_batched_k4_emits_each_scenes_sampling():
    _, model = jax_nerf_stack(4)
    ro, rd, target = (torch.from_numpy(a) for a in batches(K, 32, 6))
    loss, grads, w, z = fused_nerf_pass_grads_scenes(model.coarse, ro, rd, target, [7, 8, 9, 10],
                                                     n_samples=16, emit_sampling=True, cfg=NCFG)
    assert w.shape == z.shape == (K, 32, 16)
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads

    for k in range(K):
        l1, g1, w1, z1 = fused_nerf_pass_grads(scene_module(model.coarse, k), ro[k], rd[k],
                                               target[k], 7 + k, n_samples=16, emit_sampling=True,
                                               cfg=NCFG)
        assert float(l1) == float(loss[k]) and torch.equal(w1, w[k]) and torch.equal(z1, z[k])
        assert all(torch.equal(a[k], b) for a, b in zip(grads, g1))


def test_scene_slabs_start_16_byte_aligned():
    """Each scene's slab of a packed weight buffer is padded with zeros to a
    multiple of 4 values (the kernels' float4 weight loads); one scene is
    left as it is."""
    from tinynerf_tpu_torch.kernels.fused_train import scene_slabs

    w = torch.arange(14.0)
    got = scene_slabs(w, 2)
    assert got.shape == (2, 8) and torch.equal(got[:, :7], w.reshape(2, 7))
    assert not got[:, 7:].any()
    assert scene_slabs(w, 1).shape == (1, 14) and scene_slabs(None, 2) is None
    assert scene_slabs(torch.arange(16.0), 2).shape == (2, 8)


# 3. The stacked optimizer against jax.vmap of optax.


@pytest.mark.parametrize("levers", [False, True])
def test_stacked_adam_matches_vmapped_optax(levers):
    kw = dict(weight_decay=1e-2, lr_decay_steps=5, lr_floor=1e-4) if levers else {}
    s = dataclasses.replace(SMALL, **kw)
    js = dataclasses.replace(JSMALL, **kw)
    params, model = jax_tiny_stack(5)
    opt = settings_optimizer(model.parameters(), s, batch_dims=1)
    jopt = jax_settings_optimizer(js)
    jstate = jax.vmap(jopt.init)(params)
    jparams = params
    rng = np.random.RandomState(6)
    for _ in range(10):
        gtree = jax.tree_util.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), params)
        updates, jstate = jax.vmap(jopt.update)(gtree, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = [torch.stack([params_from_jax(jms.scene_params(gtree, k))[n] for k in range(K)])
                 for n, _ in model.named_parameters()]
        for p, g in zip(model.parameters(), grads):
            p.grad = g
        opt.step()
    got = stacked_grads_to_jax(model, [p.detach() for p in model.parameters()], state_to_jax)
    for a, b in zip(leaves(jparams), leaves(got)):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


# 4. Batched checkpoints both ways.


def test_jax_written_multiscene_checkpoint_restores_in_the_port(tmp_path):
    jopt = jax_settings_optimizer(JSMALL)
    params, _ = jms.init_multiscene_state(jax.random.PRNGKey(7), K, JSMALL)
    state = jax.vmap(jopt.init)(params)
    gtree = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.1, jnp.float32), params)
    for _ in range(3):
        updates, state = jax.vmap(jopt.update)(gtree, state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax_ms.npz")
    jckpt.save_checkpoint(path, params, state, 3,
                          meta={"scenes": K, "size": 25, "model": "tinynerf-multiscene"})
    model, opt = init_multiscene_state(0, K, SMALL)
    step, meta = ckpt.restore_checkpoint(path, model, opt, scenes=True)
    assert step == 3 and meta["model"] == "tinynerf-multiscene" and opt.count() == 3
    got = stacked_grads_to_jax(model, [p.detach() for p in model.parameters()], state_to_jax)
    for a, b in zip(leaves(params), leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)
    mu = stacked_grads_to_jax(model, [opt.state[p]["exp_avg"] for p in model.parameters()],
                              state_to_jax)
    for a, b in zip(leaves(state[0].mu), leaves(mu)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(path, *init_multiscene_state(0, 2, SMALL), scenes=True)


@pytest.mark.parametrize("kind", ["tinynerf", "nerf"])
def test_port_written_multiscene_checkpoint_restores_in_jax(tmp_path, kind):
    data = scenes_data()
    if kind == "tinynerf":
        s, init_fn, loss, to_jax = SMALL, None, None, state_to_jax
        jinit = None
    else:
        s, to_jax = NERF_S, nerf_state_to_jax
        init_fn = lambda g, d: NeRF(NCFG, generator=g, device=d)  # noqa: E731
        loss = make_hierarchical_loss(NCFG, n_fine=8)
        jinit = lambda key: jnerf.init_nerf(key, JNCFG)  # noqa: E731
    model, opt = init_multiscene_state(0, K, s, init_fn=init_fn)
    make_multiscene_train_block(s, 2, K, loss=loss)(model, opt, 1, 0, *data)
    path = str(tmp_path / "port_ms.npz")
    ckpt.save_checkpoint(path, model, opt, 2, meta={"scenes": K, "size": 5,
                                                    "model": f"{kind}-multiscene"}, scenes=True)
    js = JSMALL
    tparams, tstate = jms.init_multiscene_state(jax.random.PRNGKey(0), K, js, init_fn=jinit)
    jparams, jstate, step, meta = jckpt.restore_checkpoint(path, tparams, tstate)
    assert step == 2 and meta == {"scenes": K, "size": 5, "model": f"{kind}-multiscene"}
    assert np.asarray(jstate[0].count).shape == (K,) and int(np.asarray(jstate[0].count)[0]) == 2
    got = stacked_grads_to_jax(model, [p.detach() for p in model.parameters()], to_jax)
    assert str(jax.tree_util.tree_structure(jparams)) == str(jax.tree_util.tree_structure(got))
    for a, b in zip(leaves(jparams), leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)
    info = ckpt.read_meta(path)
    assert info["param_struct"] == ckpt.tree_struct(jax.tree_util.tree_map(np.asarray, jparams))


# 5. Scenes stay independent; a block learns.


@pytest.mark.parametrize("kind,fused", [("tinynerf", False), ("tinynerf", True),
                                        ("nerf", False), ("nerf", True)])
def test_batched_block_equals_independent_single_scene_runs(kind, fused):
    """tests/test_multiscene.py:54-88: a K-scene block of 5 steps equals K
    single-scene runs (make_train_block with scene k's seed) on each
    scene's data; sigma-noise on."""
    data = scenes_data()
    if kind == "tinynerf":
        s = dataclasses.replace(SMALL, sigma_noise_std=0.3)
        init_fn, loss = None, None
        gf, gf1 = (make_fused_grad_fn_scenes(s), make_fused_grad_fn(s)) if fused else (None, None)
    else:
        s = dataclasses.replace(NERF_S, sigma_noise_std=0.3)
        init_fn = lambda g, d: NeRF(NCFG, generator=g, device=d)  # noqa: E731
        loss = make_hierarchical_loss(NCFG, n_fine=8)
        gf, gf1 = ((make_fused_nerf_grad_fn_scenes(s, NCFG, n_fine=8),
                    make_fused_nerf_grad_fn(s, NCFG, n_fine=8)) if fused else (None, None))
    model, opt = init_multiscene_state(0, K, s, init_fn=init_fn)
    m = make_multiscene_train_block(s, 5, K, loss=loss, grad_fn=gf)(model, opt, 7, 0, *data)
    assert m["loss"].shape == (5, K)
    single = make_train_block(s, 5, loss=loss, grad_fn=gf1)
    for k in range(K):
        m1, o1 = init_train_state(torch.Generator().manual_seed(scene_seed(0, k)), s,
                                  init_fn=init_fn)
        r = single(m1, o1, scene_seed(7, k), 0, data[0][k], data[1][k], data[2][k])
        for a, b in zip(scene_params(model, k).parameters(), m1.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(m["loss"][:, k].numpy(), r["loss"].numpy(), atol=1e-6)


def test_multiscene_block_learns():
    """tests/test_multiscene.py:38-51: the mean loss falls >= 5 % over 3
    blocks (the fused step, its plain version on the CPU)."""
    data = scenes_data()
    model, opt = init_multiscene_state(0, K, SMALL)
    block = make_multiscene_train_block(SMALL, 30, K, grad_fn=make_fused_grad_fn_scenes(SMALL))
    losses = []
    for b in range(3):
        m = block(model, opt, 1, b * 30, *data)
        assert m["loss"].shape == (30, K)
        losses.append(float(m["loss"].mean()))
    assert losses[-1] < losses[0] * 0.95, losses


# 6. Divisibility, ranks, the driver.


def test_multiscene_divisibility_check():
    with pytest.raises(ValueError, match="not divisible"):
        make_multiscene_train_block(SMALL, 2, 3, make_mesh(n_devices=2))
    with pytest.raises(ValueError, match="1-D"):
        local_scenes(4, make_mesh(n_devices=2, sample_parallel=2))
    assert local_scenes(8, make_mesh(n_devices=4, rank=2)) == [4, 5]
    from tinynerf_tpu_torch.train_multiscene import MultiSceneConfig, main

    with pytest.raises(ValueError, match="needs that many ranks"):
        main(MultiSceneConfig(n_devices=2, device="cpu"))


def _rank_job(rank, world, init, out):
    torch.set_num_threads(1)
    assert initialize_distributed(init_method=init, world_size=world, rank=rank,
                                  device_type="cpu")
    from tinynerf_tpu_torch.multiscene import gather_state

    mesh = make_mesh()
    data = [x[local_scenes(K, mesh)] for x in scenes_data()]
    s = dataclasses.replace(SMALL, sigma_noise_std=0.3)
    with torch.enable_grad():
        model, opt = init_multiscene_state(0, K, s, mesh=mesh)
        for fused in (False, True):
            gf = make_fused_grad_fn_scenes(s) if fused else None
            make_multiscene_train_block(s, 3, K, mesh, grad_fn=gf)(model, opt, 5, 3 * fused, *data)
    full, _ = gather_state(model, opt, mesh)
    torch.save([p.detach() for p in full.parameters()], os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_two_gloo_ranks_are_bit_identical_to_one(tmp_path):
    ctx = mp.spawn(_rank_job, args=(2, f"file://{tmp_path / 'store'}", str(tmp_path)), nprocs=2,
                   join=False)
    deadline = time.time() + 300
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("2 ranks did not finish in 300 s")
    s = dataclasses.replace(SMALL, sigma_noise_std=0.3)
    model, opt = init_multiscene_state(0, K, s)
    data = scenes_data()
    for fused in (False, True):
        gf = make_fused_grad_fn_scenes(s) if fused else None
        make_multiscene_train_block(s, 3, K, grad_fn=gf)(model, opt, 5, 3 * fused, *data)
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert all(torch.equal(a, b.detach()) for a, b in zip(got, model.parameters()))


def test_driver_on_the_cpu_writes_checkpoint_and_previews(tmp_path):
    from tinynerf_tpu_torch.train_multiscene import MultiSceneConfig, main

    cfg = MultiSceneConfig(scenes=2, size=16, poses_per_scene=2, iters=4, log_every=2, n_rand=32,
                           n_samples=8, hidden=32, num_freqs=4, device="cpu",
                           out_dir=str(tmp_path / "out"), ckpt_path=str(tmp_path / "ms.npz"),
                           data_dir=str(tmp_path / "data"))
    res = main(cfg)
    assert res["rays_per_sec"] > 0 and len(res["psnr_last"]) == 2
    assert sorted(os.listdir(tmp_path / "out")) == ["scene_000.png", "scene_001.png"]
    assert sorted(os.listdir(tmp_path / "data")) == ["scene_000_16.npz", "scene_001_16.npz"]
    info = ckpt.read_meta(str(tmp_path / "ms.npz"))
    assert info["meta"] == {"scenes": 2, "size": 16, "model": "tinynerf-multiscene"}
    with np.load(tmp_path / "ms.npz") as z:
        assert z["opt_0"].shape == (2,) and int(z["opt_0"][0]) == 4
        assert z["param_0"].shape[0] == 2
