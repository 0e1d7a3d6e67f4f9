"""K1 and K2 at every TinyNeRF shape the JAX kernels take, and the scene
axis at widths off multiples of 8, on the CPU.

The JAX kernels take any batch (the ray tile shrinks to the batch), any
width and any sample count; the port's wrappers used to refuse batches
off the ray tile (S=20: tiles of 3 rays), widths off multiples of 8
(hidden 36), tiles whose activations pass 227 KB of shared memory
(hidden 168 or 256, depth 6, S=96 or 128) and K1 blocks past 512 threads
(hidden 264, S=192 at hidden 256, S=512). Here, on the CPU, where each
wrapper runs its kernel's plain version:

- the wrappers at those shapes against the JAX package's references:
  jax.grad of tinynerf_tpu/training.py:268 loss_fn (at grid depths) and
  tinynerf_tpu/render.py:30 render_rays;
- the padding the card's launches use is exact: a model zero-padded to a
  multiple of 8 units (padded_tiny_widths, stacked scenes alike; the
  NeRF MLP's padded_widths on a stack), and rays appended to a batch
  (pad_ray_batch) that add nothing to the loss or the gradients;
- the route rules (k2_fits_shared_memory, k2_uses_tensor_cores,
  k1_shape): the recipe keeps its routes, every F4 shape takes the
  spill route or K1's general kernel, and no shape raises;
- the drivers: train at hidden 36 with 20 samples, and train_multiscene
  at hidden 36, on the fused route.

The kernels themselves are held to their plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py's phase 37.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu import render as jrender
from tinynerf_tpu import training as jtraining
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import init_tinynerf
from tinynerf_tpu.ops.sampling import stratified_samples as jax_stratified
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.kernels import fused_train
from tinynerf_tpu_torch.kernels.fused_nerf import padded_widths, unpad_grads
from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads_plain
from tinynerf_tpu_torch.kernels.fused_render import (
    fused_render_rays,
    fused_render_rays_plain,
    k1_shape,
    padded_tiny_widths,
    unpad_tiny_grads,
)
from tinynerf_tpu_torch.kernels.fused_train import (
    fused_loss_grads,
    fused_loss_grads_plain,
    k2_fits_shared_memory,
    k2_route,
    k2_smem_bytes,
    k2_uses_tensor_cores,
    make_fused_grad_fn,
    make_fused_grad_fn_scenes,
    pad_ray_batch,
)
from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
from tinynerf_tpu_torch.models.stacked import stack_models
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.multiscene import (
    init_multiscene_state,
    make_multiscene_train_block,
    scene_params,
    scene_seed,
)
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.training import TrainSettings, init_train_state, make_train_block

L = 4


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def _case(R, hidden, depth=4, skip_at=2, seed=0):
    """The JAX package's params and config, the port's TinyNeRF holding
    them (f32), and R rays with targets."""
    jcfg = JaxConfig(in_dim=encoding_dim(L), hidden=hidden, depth=depth, skip_at=skip_at,
                     compute_dtype=jnp.float32)
    params = init_tinynerf(jax.random.PRNGKey(seed), jcfg)
    cfg = TinyNeRFConfig(in_dim=jcfg.in_dim, hidden=hidden, depth=depth, skip_at=skip_at,
                         compute_dtype=torch.float32)
    model = TinyNeRF(cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return params, jcfg, model, cfg, ro, rd, rng.rand(R, 3).astype(np.float32)


def _leaf_close(got, want, tol):
    """Every leaf within tol * max|leaf| of the reference."""
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


# (R, S, hidden, depth, skip_at): hidden 36 (F4b); S=20, tiles of 3 rays
# and 64 % 3 != 0 (F4a: the parent raised); S=96 (F4c on the card); the
# NeRF paper's 8-layer trunk with its skip at 4, hidden 40.
K2_SHAPES = {"hidden 36": (64, 16, 36, 4, 2), "F4a S=20": (64, 20, 32, 4, 2),
             "S=96": (16, 96, 32, 4, 2), "depth 8, skip 4, hidden 40": (32, 16, 40, 8, 4)}


@pytest.mark.parametrize("shape", list(K2_SHAPES))
def test_k2_wrapper_matches_jax_grad_of_loss_fn(shape, monkeypatch):
    """fused_loss_grads (its CPU path) against jax.grad of the JAX
    package's loss_fn at the grid depths: loss rel. 1e-5, each leaf
    2e-4 max|leaf| (tests/test_fused_train.py:51-59)."""
    R, S, hidden, depth, skip_at = K2_SHAPES[shape]
    params, jcfg, model, cfg, ro, rd, tgt = _case(R, hidden, depth, skip_at)
    monkeypatch.setattr(jtraining, "stratified_samples",
                        lambda near, far, n, o, d, randomized=True, key=None:
                        jax_stratified(near, far, n, o, d, randomized=False))
    s = jtraining.TrainSettings(n_rand=R, n_samples=S, num_freqs=L, model_cfg=jcfg)
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), jax.random.PRNGKey(0), s)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jtraining.loss_fn(p, *args)[0]))(
        params)
    loss, grads = fused_loss_grads(model, torch.from_numpy(ro), torch.from_numpy(rd),
                                   torch.from_numpy(tgt), 0, n_samples=S, num_freqs=L,
                                   randomized=False, model_cfg=cfg)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    named = {n: g for (n, _), g in zip(model.named_parameters(), grads)}
    _leaf_close(jax.tree_util.tree_leaves(state_to_jax(named)), jax.tree_util.tree_leaves(want),
                2e-4)


K1_SHAPES = {"hidden 36": (64, 16, 36, 4, 2), "S=192": (16, 192, 32, 4, 2),
             "depth 8, skip 4, hidden 40": (32, 16, 40, 8, 4)}


@pytest.mark.parametrize("shape", list(K1_SHAPES))
def test_k1_wrapper_matches_jax_render_rays(shape):
    """fused_render_rays (its CPU path) against the JAX package's
    render_rays: the image within 2e-5."""
    R, S, hidden, depth, skip_at = K1_SHAPES[shape]
    params, jcfg, model, cfg, ro, rd, _ = _case(R, hidden, depth, skip_at, seed=1)
    want = jrender.render_rays(params, jnp.asarray(ro), jnp.asarray(rd), n_samples=S,
                               num_freqs=L, model_cfg=jcfg)
    with torch.no_grad():
        got = fused_render_rays(model, torch.from_numpy(ro), torch.from_numpy(rd), n_samples=S,
                                num_freqs=L, model_cfg=cfg)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-5


@pytest.mark.parametrize("hidden,depth,skip_at", [(36, 4, 2), (36, 8, 4), (13, 3, 1)])
def test_width_padding_is_exact(hidden, depth, skip_at):
    """The model padded to a multiple of 8 units (zero rows inserted
    between hidden and hidden_pad, before the skip layer's encoding
    columns) renders the same image (1e-6) and, unpadded, gives the same
    loss and gradients (1e-6 max|leaf|); a stack of scenes pads each
    scene as it pads alone."""
    _, _, model, cfg, ro, rd, tgt = _case(24, hidden, depth, skip_at, seed=2)
    model_p, cfg_p = padded_tiny_widths(model, cfg)
    assert cfg_p.hidden == -(-hidden // 8) * 8 and model_p.layers[0].out_features == cfg_p.hidden
    t = [torch.from_numpy(x) for x in (ro, rd, tgt)]
    kw = dict(n_samples=16, num_freqs=L)
    with torch.no_grad():
        img = fused_render_rays_plain(model, *t[:2], model_cfg=cfg, **kw)
        img_p = fused_render_rays_plain(model_p, *t[:2], model_cfg=cfg_p, **kw)
    assert float((img - img_p).abs().max()) <= 1e-6
    loss, grads = fused_loss_grads_plain(model, *t, 0, randomized=False, model_cfg=cfg, **kw)
    loss_p, raw = fused_loss_grads_plain(model_p, *t, 0, randomized=False, model_cfg=cfg_p,
                                         **kw)
    grads_p = unpad_tiny_grads(raw, cfg, cfg_p)
    assert [g.shape for g in grads_p] == [p.shape for p in model.parameters()]
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * float(loss)
    _leaf_close(grads_p, grads, 1e-6)
    other = TinyNeRF(cfg, generator=torch.Generator().manual_seed(5))
    stack_p, _ = padded_tiny_widths(stack_models([model, other]), cfg)
    for k, m in enumerate((model, other)):
        alone, _ = padded_tiny_widths(m, cfg)
        assert all(torch.equal(a[k], b) for a, b in zip(stack_p.parameters(), alone.parameters()))
    stacked = unpad_tiny_grads([torch.stack([g, 2 * g]) for g in raw], cfg, cfg_p)
    assert all(torch.equal(a[0], b) and torch.equal(a[1], 2 * b)
               for a, b in zip(stacked, grads_p))


def test_nerf_width_padding_of_a_stack_matches_each_scene():
    """padded_widths and unpad_grads on a stack of NeRF MLPs (hidden 36,
    rgb_hidden 20: padded to 40 and 24) act on each scene as on the
    scene alone; the padded pass's gradients unpadded equal the unpadded
    pass's (1e-6 max|leaf|)."""
    cfg = NeRFConfig(num_freqs=L, num_freqs_dir=2, hidden=36, depth=3, skip_at=2, rgb_hidden=20,
                     compute_dtype=torch.float32)
    mlps = [NeRFMLP(cfg, generator=torch.Generator().manual_seed(k)) for k in range(2)]
    stack_p, cfg_p = padded_widths(stack_models(mlps), cfg)
    assert (cfg_p.hidden, cfg_p.rgb_hidden) == (40, 24)
    for k, m in enumerate(mlps):
        alone, _ = padded_widths(m, cfg)
        assert all(torch.equal(a[k], b) for a, b in zip(stack_p.parameters(), alone.parameters()))
    _, _, _, _, ro, rd, tgt = _case(16, 8, seed=3)
    t = [torch.from_numpy(x) for x in (ro, rd, tgt)]
    z = torch.sort(torch.rand(16, 12, generator=torch.Generator().manual_seed(1)) * 4 + 2).values
    loss, grads = fused_nerf_pass_grads_plain(mlps[0], *t, 0, z, cfg=cfg)[:2]
    alone, _ = padded_widths(mlps[0], cfg)
    loss_p, grads_p = fused_nerf_pass_grads_plain(alone, *t, 0, z, cfg=cfg_p)[:2]
    assert abs(float(loss) - float(loss_p)) <= 1e-6 * float(loss)
    _leaf_close(unpad_grads(grads_p, cfg, cfg_p), grads, 1e-6)
    both = unpad_grads([torch.stack([g, g]) for g in grads_p], cfg, cfg_p)
    assert all(torch.equal(a[0], b) for a, b in zip(both, unpad_grads(grads_p, cfg, cfg_p)))


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_masked_ray_padding_leaves_the_real_rays_unchanged(white_bkgd):
    """pad_ray_batch's rays (origin and direction 0, the background as the
    target) composite to exactly their target and add nothing: 64 rays
    padded with 64 more give, at twice the mean's weight, the loss and
    gradients of the 64 alone (1e-6; the factor 2 is exact); the padded
    rays' noise is 0 and the real rays keep their rows."""
    _, _, model, cfg, ro, rd, tgt = _case(64, 36, seed=4)
    noise = torch.randn(64, 20, generator=torch.Generator().manual_seed(2))
    t = [torch.from_numpy(x)[None] for x in (ro, rd, tgt)]
    o, d, g, n = pad_ray_batch(*t, noise[None], 64, white_bkgd)
    assert o.shape == (1, 128, 3) and n.shape == (1, 128, 20) and torch.equal(o[0, :64], t[0][0])
    assert float(n[0, 64:].abs().max()) == 0.0
    kw = dict(n_samples=20, num_freqs=L, randomized=False, white_bkgd=white_bkgd, model_cfg=cfg)
    with torch.no_grad():
        bg = fused_render_rays_plain(model, o[0, 64:], d[0, 64:], n_samples=20, num_freqs=L,
                                     white_bkgd=white_bkgd, model_cfg=cfg)
    assert torch.equal(bg, g[0, 64:])
    loss, grads = fused_loss_grads_plain(model, *(x[0, :64] for x in (o, d, g)), 0,
                                         sigma_noise=noise, **kw)
    loss_p, grads_p = fused_loss_grads_plain(model, o[0], d[0], g[0], 0, sigma_noise=n[0], **kw)
    assert abs(2 * float(loss_p) - float(loss)) <= 1e-6 * float(loss)
    _leaf_close([2 * x for x in grads_p], grads, 1e-6)


def _tiny(hidden, depth=4, skip_at=2, dtype=torch.float32, L=10):
    return TinyNeRFConfig(in_dim=encoding_dim(L), hidden=hidden, depth=depth, skip_at=skip_at,
                          compute_dtype=dtype)


def test_route_rules():
    """The recipe keeps its routes (shared memory; bf16 on the tensor
    cores, f32 on the CUDA cores; K1's tiles of 2 rays); every F4c shape
    takes K2's spill route at the shared-memory sizes of
    csrc/fused_train.cu, and every F4d shape K1's general kernel; no
    shape raises."""
    for dtype in (torch.float32, torch.bfloat16):
        recipe = _tiny(128, dtype=dtype)
        assert k2_fits_shared_memory(recipe, 64) and k2_smem_bytes(recipe, 64) == 185108
        assert k2_uses_tensor_cores(recipe, 64) is (dtype == torch.bfloat16)
        assert k1_shape(recipe, 64) == (dtype == torch.bfloat16, False, 2, 64)
    bf16 = torch.bfloat16
    assert k2_route(_tiny(128, dtype=bf16), 64) == "shared memory, tensor cores"
    assert k2_route(_tiny(256, 8, 4, bf16), 64) == "spill, tensor cores"
    assert k2_route(_tiny(36, dtype=torch.float32), 20) == "shared memory, CUDA cores"
    f4c = {(168, 4, 2, 64): 236308, (256, 4, 2, 64): 348948, (128, 6, 3, 64): 251156,
           (128, 4, 2, 96): 277652, (128, 4, 2, 128): 370196, (256, 8, 4, 64): 612116}
    for (hidden, depth, skip_at, S), nbytes in f4c.items():
        cfg = _tiny(hidden, depth, skip_at)
        assert k2_smem_bytes(cfg, S) == nbytes and not k2_fits_shared_memory(cfg, S)
    f32 = torch.float32
    assert k1_shape(_tiny(264, dtype=f32), 64)[:2] == (False, True)
    assert k1_shape(_tiny(256, dtype=f32), 192) == (False, True, 1, 128)
    assert k1_shape(_tiny(128, dtype=f32), 512) == (False, True, 1, 128)
    assert k1_shape(_tiny(256), 192) == (False, True, 1, 128)  # bf16 past 128 points
    for hidden in (1, 8, 36, 128, 264, 1000):
        for S in (2, 3, 20, 64, 96, 192, 512, 1000):
            for depth, skip_at in ((1, 0), (4, 2), (8, 4)):
                for dtype in (torch.float32, torch.bfloat16):
                    cfg = _tiny(hidden, depth, skip_at, dtype)
                    k2_route(cfg, S)
                    cfg8 = dataclasses.replace(cfg, hidden=-(-hidden // 8) * 8)
                    mma, general, tile, seg = k1_shape(cfg8, S)
                    assert tile >= 1 and (seg == S or (tile == 1 and 8 <= seg < S))


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=4, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def test_train_takes_hidden_36_and_20_samples_on_the_fused_route(tiny_npz, tmp_path, monkeypatch):
    """python -m tinynerf_tpu_torch.train --hidden 36 --n-samples 20 with
    64 rays (tiles of 3 on the card): every step through K2's plain
    version on the CPU, a finite held-out PSNR."""
    calls = []
    plain = fused_train.fused_loss_grads_plain
    monkeypatch.setattr(fused_train, "fused_loss_grads_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    res = train.main(Config(data_path=tiny_npz, out_dir=str(tmp_path / "out"), device="cpu",
                            iters=4, n_rand=64, n_samples=20, hidden=36, num_freqs=L,
                            log_every=2, ckpt_path=str(tmp_path / "ckpt.npz"), resume=False,
                            holdout=1, chunk=256))
    assert len(calls) == 4 and np.isfinite(res["final_psnr"])
    assert np.isfinite(res["eval"]["psnr_mean"])


@pytest.mark.parametrize("kind", ["tinynerf", "nerf"])
def test_batched_block_at_widths_off_8_equals_single_scene_runs(kind):
    """The fused multi-scene block at hidden 36 (TinyNeRF, 20 samples: 32
    rays are no whole number of tiles) and at NeRF hidden 36 / rgb_hidden
    20 equals each scene's single-scene run (tests/test_multiscene.py:
    54-88)."""
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        make_fused_nerf_grad_fn,
        make_fused_nerf_grad_fn_scenes,
    )
    from tinynerf_tpu_torch.models.nerf import NeRF

    K = 2
    rng = np.random.RandomState(0)
    ro = (rng.randn(K, 2, 25, 3) * 0.1).astype(np.float32)
    rd = rng.randn(K, 2, 25, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    data = [torch.from_numpy(a) for a in (ro, rd, rng.rand(K, 2, 25, 3).astype(np.float32))]
    if kind == "tinynerf":
        s = TrainSettings(n_rand=32, n_samples=20, num_freqs=L, sigma_noise_std=0.3,
                          model_cfg=_tiny(36, L=L))
        init_fn = None
        gf, gf1 = make_fused_grad_fn_scenes(s), make_fused_grad_fn(s)
    else:
        ncfg = NeRFConfig(num_freqs=L, num_freqs_dir=2, hidden=36, depth=3, skip_at=2,
                          rgb_hidden=20, compute_dtype=torch.float32)
        s = TrainSettings(n_rand=32, n_samples=8, num_freqs=L, sigma_noise_std=0.3)
        init_fn = lambda g, d: NeRF(ncfg, generator=g, device=d)  # noqa: E731
        gf = make_fused_nerf_grad_fn_scenes(s, ncfg, n_fine=8)
        gf1 = make_fused_nerf_grad_fn(s, ncfg, n_fine=8)
    model, opt = init_multiscene_state(0, K, s, init_fn=init_fn)
    m = make_multiscene_train_block(s, 3, K, grad_fn=gf)(model, opt, 7, 0, *data)
    single = make_train_block(s, 3, grad_fn=gf1)
    for k in range(K):
        m1, o1 = init_train_state(torch.Generator().manual_seed(scene_seed(0, k)), s,
                                  init_fn=init_fn)
        r = single(m1, o1, scene_seed(7, k), 0, data[0][k], data[1][k], data[2][k])
        for a, b in zip(scene_params(model, k).parameters(), m1.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(m["loss"][:, k].numpy(), r["loss"].numpy(), atol=1e-6)


def test_train_multiscene_driver_at_hidden_36(tmp_path):
    """python -m tinynerf_tpu_torch.train_multiscene --hidden 36 on the
    fused route (the batched K2's plain version on the CPU)."""
    from tinynerf_tpu_torch.train_multiscene import MultiSceneConfig, main

    res = main(MultiSceneConfig(scenes=2, size=16, poses_per_scene=2, iters=2, log_every=1,
                                n_rand=32, n_samples=20, hidden=36, num_freqs=L, device="cpu",
                                out_dir=str(tmp_path / "out"), ckpt_path=str(tmp_path / "ms.npz"),
                                data_dir=str(tmp_path / "data"), preview=False))
    assert len(res["psnr_last"]) == 2 and np.all(np.isfinite(res["psnr_last"]))
