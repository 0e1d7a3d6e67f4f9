"""Port parity for ROADMAP item 12, the grid model family
(models/grid_nerf.py): corner ids and trilinear weights, the encoding,
the model in f32 and bf16, the single-pass render, the loss gradients
(tables included) against jax.grad, 20 AdamW + EMA steps, the sparsity
prior's gradients, checkpoints across the packages both ways, and the
port's drivers (train trains, resumes, evals, makes a depth GIF, runs
under --ndc and on two gloo ranks; the two refusals), on the CPU.

The JAX tests' TINY grid (tests/test_grid_nerf.py:20-31): 3 levels at
resolutions 4, 8, 16 over the box [-1, 1]^3, a 2^10-entry table (two
dense levels, one hashed), hidden 16, 7 geometry features, L_dir 2.
Inputs come from numpy with a seed; JAX parameters are carried across
with grid_params_from_jax. The JAX family has no Pallas kernel.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinynerf_tpu import render as jrender
from tinynerf_tpu import train as jtrain
from tinynerf_tpu import training as jtraining
from tinynerf_tpu.config import Config as JConfig
from tinynerf_tpu.models import grid_nerf as jgrid
from tinynerf_tpu.ops import regularizers as jreg
from tinynerf_tpu.utils import checkpoint as jckpt
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import make_gif as gif_mod
from tinynerf_tpu_torch import render, synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models import grid_nerf
from tinynerf_tpu_torch.models.grid_nerf import (
    GridNeRF,
    GridNeRFConfig,
    grid_params_from_jax,
    grid_params_to_jax,
    grid_state_to_jax,
)
from tinynerf_tpu_torch.models.tinynerf import count_params
from tinynerf_tpu_torch.ops.regularizers import make_sparsity_grad_fn
from tinynerf_tpu_torch.ops.rays import get_rays
from tinynerf_tpu_torch.training import TrainSettings, make_optimizer
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

TINY = dict(n_levels=3, features=2, base_res=4, max_res=16, table_size=1 << 10, hidden=16,
            geo_features=7, num_freqs_dir=2, aabb=(-1.0, -1.0, -1.0, 1.0, 1.0, 1.0))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _grad_enabled():
    # tests/test_torch_parity.py turns autograd off for its whole worker.
    with torch.enable_grad():
        yield


def pair(seed=0, table_scale=0.5, dtype=torch.float32):
    """JAX params and a port GridNeRF holding the same weights; the tables
    drawn at table_scale (the 1e-4 init would leave the features
    invisible), the sigma bias raised so that rays gather opacity."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jgrid.GridNeRFConfig(compute_dtype=jdt, **TINY)
    params = jax.tree_util.tree_map(np.asarray,
                                    jgrid.init_grid_nerf(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    params["tables"] = {k: rng.uniform(-table_scale, table_scale, v.shape).astype(np.float32)
                        for k, v in params["tables"].items()}
    params["mlp"]["geo1"]["b"] = params["mlp"]["geo1"]["b"] + np.float32(1.0)
    tcfg = GridNeRFConfig(compute_dtype=dtype, **TINY)
    model = GridNeRF(tcfg)
    model.load_state_dict(grid_params_from_jax(params))
    return params, jcfg, model, tcfg


def points(n, seed, lo=-1.1, hi=1.1):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    return pts, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def rays(n, seed):
    """n rays of a hemisphere pose of radius 4 (near 2, far 6), rescaled
    into the TINY box: origins and directions over 2.5."""
    pose = synthetic.hemisphere_poses(8)[seed % 8]
    ro, rd = get_rays(20, 20, 25.0, torch.from_numpy(pose))
    idx = np.random.RandomState(seed).choice(400, n, replace=False)
    return (ro[idx] / 2.5).numpy(), (rd[idx] / 2.5).numpy()


def leaves_close(port_tree, jax_tree, scale=1e-5):
    for a, b in zip(jax.tree_util.tree_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)):
        b = np.asarray(b, dtype=np.float32)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                                   atol=scale * max(float(np.abs(b).max()), 1e-30))


def test_config_ladder_and_split_match_jax():
    for kw in (TINY, {}, dict(n_levels=1), dict(n_levels=12, base_res=8, max_res=512)):
        j, t = jgrid.GridNeRFConfig(**kw), GridNeRFConfig(**kw)
        assert t.level_resolutions() == j.level_resolutions()
        assert t.level_table_sizes() == j.level_table_sizes()
        assert t.level_is_dense() == j.level_is_dense()
    assert GridNeRFConfig(**TINY).level_is_dense() == (True, True, False)
    # The full width: 4 dense levels, 4 hashed, 1,273,971 parameters.
    full = GridNeRF(generator=torch.Generator().manual_seed(0))
    jfull = jgrid.init_grid_nerf(jax.random.PRNGKey(0))
    assert count_params(full) == jgrid.count_params(jfull) == 1273971
    assert sum(full.cfg.level_is_dense()) == 4
    for name, t in full.tables.items():
        assert float(t.detach().abs().max()) <= 1e-4, name


@pytest.mark.parametrize("level", [0, 1, 2])
def test_corner_ids_exact_and_weights_match_jax(level):
    """Dense (levels 0, 1) and hashed (level 2) corner ids equal the JAX
    package's, points exactly on cell faces and on the box's far face
    included; trilinear weights rtol 1e-6."""
    cfg = GridNeRFConfig(**TINY)
    res, dense = cfg.level_resolutions()[level], cfg.level_is_dense()[level]
    rng = np.random.RandomState(level)
    u = rng.rand(2000, 3).astype(np.float32)
    u[:200] = (rng.randint(0, res + 1, (200, 3)) / res).astype(np.float32)  # on faces, u == 1
    jl, jw = jgrid._level_ids(jnp.asarray(u), res, dense, cfg.table_size)
    tl, tw = grid_nerf.level_ids(torch.from_numpy(u), res, dense, cfg.table_size)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.min()) >= 0 and int(tl.max()) < cfg.level_table_sizes()[level]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=0)


def test_hash_matches_uint32_at_large_ids():
    """The int64 hash equals the uint32 one at ids near 2^31, where the
    products wrap uint32 many times over."""
    ids = np.random.RandomState(3).randint(2**31 - 2**20, 2**31 - 1, (64, 3)).astype(np.uint64)
    p = grid_nerf._HASH_PRIMES
    for table_size in (1 << 10, 1 << 17, 1 << 32):
        want = ((ids[:, 0] * p[0]) ^ (ids[:, 1] * p[1]) ^ (ids[:, 2] * p[2])) % (1 << 32)
        want &= table_size - 1
        t = torch.from_numpy(ids.astype(np.int64))
        m = table_size - 1
        got = ((t[:, 0] * p[0]) & m) ^ ((t[:, 1] * p[1]) & m) ^ ((t[:, 2] * p[2]) & m)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


def test_grid_encode_matches_jax():
    params, jcfg, model, tcfg = pair(1)
    pts, _ = points(1500, 1)
    want = np.asarray(jgrid.grid_encode(params["tables"], jnp.asarray(pts), jcfg))
    got = grid_nerf.grid_encode(model.tables, torch.from_numpy(pts), tcfg).detach().numpy()
    assert got.shape == (1500, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_apply_matches_jax_f32_and_bf16():
    """f32: rgb and sigma within 1e-5. bf16: rgb under the bf16 render gates
    (per-point max channel: p99.9 < 3e-2, mean < 1e-3), sigma within 3e-2
    of its max."""
    for dtype in (torch.float32, torch.bfloat16):
        params, jcfg, model, tcfg = pair(2, dtype=dtype)
        pts, d = points(1000, 2)
        noise = np.random.RandomState(3).randn(1000).astype(np.float32) * 0.3
        jr, js = jgrid.apply_grid_nerf(params, jnp.asarray(pts), jnp.asarray(d), jcfg,
                                       sigma_noise=jnp.asarray(noise))
        tr, ts = model(torch.from_numpy(pts), torch.from_numpy(d), tcfg,
                       sigma_noise=torch.from_numpy(noise))
        jr, js, tr, ts = np.asarray(jr), np.asarray(js), tr.detach().numpy(), ts.detach().numpy()
        assert tr.shape == (1000, 3) and ts.shape == (1000,) and (ts > 0).mean() > 0.5
        if dtype == torch.float32:
            np.testing.assert_allclose(tr, jr, atol=1e-5)
            np.testing.assert_allclose(ts, js, atol=1e-5)
        else:
            err = np.abs(tr - jr).max(axis=-1)
            assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3
            assert np.abs(ts - js).max() <= 3e-2 * np.abs(js).max()


@pytest.mark.parametrize("aux", [False, True])
def test_render_rays_and_image_match_jax(aux):
    """render_rays_grid at deterministic depths (image 1e-5) and the
    chunked image renderer (colour, or the aux channels: acc everywhere,
    depth where acc >= 0.1), f32."""
    params, jcfg, model, tcfg = pair(3)
    ro, rd = rays(128, 3)
    kw = dict(n_samples=24, near=0.8, far=2.4)
    jc, jd, ja, _, jz = jgrid.render_rays_grid(params, jnp.asarray(ro), jnp.asarray(rd), None,
                                               cfg=jcfg, **kw)
    tc, td, ta, _, tz = grid_nerf.render_rays_grid(model, torch.from_numpy(ro),
                                                   torch.from_numpy(rd), None, cfg=tcfg, **kw)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(ja), atol=1e-5)
    assert float(ta.detach().mean()) > 0.2
    pose = synthetic.hemisphere_poses(8)[5]
    pose[:3, 3] /= 2.5
    img = dict(H=12, W=12, focal=15.0, chunk=64, n_samples=24, near=0.8, far=2.4, aux=aux)
    want = np.asarray(jrender.make_grid_image_renderer(grid_cfg=jcfg, **img)(params,
                                                                          jnp.asarray(pose)))
    got = render.make_grid_image_renderer(grid_cfg=tcfg, **img)(model, torch.from_numpy(pose))
    got = got.numpy()
    assert got.shape == (12, 12, 3)
    if aux:
        np.testing.assert_allclose(got[..., 1], want[..., 1], atol=1e-5)
        mask = want[..., 1] >= 0.1
        assert mask.mean() > 0.3
        np.testing.assert_allclose(got[..., 0][mask], want[..., 0][mask], atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_loss(jcfg, ro, rd, target, noise, n_samples=16, near=0.8, far=2.4):
    def loss(p):
        comp, _, _, _, _ = jgrid.render_rays_grid(p, ro, rd, None, cfg=jcfg, n_samples=n_samples,
                                                  near=near, far=far, sigma_noise=noise)
        return jnp.mean((comp - target) ** 2)

    return loss


def _port_loss(model, tcfg, ro, rd, target, noise, n_samples=16, near=0.8, far=2.4):
    comp, _, _, _, _ = grid_nerf.render_rays_grid(model, ro, rd, None, cfg=tcfg,
                                                  n_samples=n_samples, near=near, far=far,
                                                  sigma_noise=noise)
    return torch.mean((comp - target) ** 2)


def test_loss_and_every_leaf_match_jax_grad():
    """The MSE of one pass at deterministic depths with a given sigma-noise:
    loss and every leaf, the tables included, within 1e-5 of the leaf's
    max against jax.grad."""
    params, jcfg, model, tcfg = pair(4)
    ro, rd = rays(96, 4)
    target = np.random.RandomState(5).rand(96, 3).astype(np.float32)
    noise = (np.random.RandomState(6).randn(96 * 16) * 0.5).astype(np.float32)
    want_loss, want = jax.value_and_grad(_jax_loss(jcfg, *map(jnp.asarray, (ro, rd, target,
                                                                          noise))))(params)
    value = _port_loss(model, tcfg, *map(torch.from_numpy, (ro, rd, target, noise)))
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(want_loss), rtol=1e-5)
    got = grid_state_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert all(float(np.abs(g).max()) > 0 for g in jax.tree_util.tree_leaves(got))
    leaves_close(got, want)


def test_loss_contract_and_draws():
    """make_grid_loss: the training.loss_fn contract; the generator draws
    the sigma-noise (only when on), then the jitter, so one generator seed
    replays the loss; the PSNR is the MSE's."""
    _, _, model, tcfg = pair(5)
    ro, rd = map(torch.from_numpy, rays(64, 5))
    target = torch.rand(64, 3, generator=torch.Generator().manual_seed(1))
    loss = grid_nerf.make_grid_loss(tcfg)
    s = TrainSettings(n_rand=64, n_samples=16, near=0.8, far=2.4, sigma_noise_std=0.5)

    def run(seed, settings=s, scale=1.0):
        return loss(model, ro, rd, target, torch.Generator().manual_seed(seed), settings,
                    noise_scale=scale)

    a, m = run(7)
    assert float(a) == float(run(7)[0]) and float(a) != float(run(8)[0])
    assert abs(float(m["psnr"]) + 10 * np.log10(float(a))) < 1e-4
    quiet = dataclasses.replace(s, sigma_noise_std=0.0)
    # Without noise the jitter is the generator's first draw.
    gen = torch.Generator().manual_seed(7)
    comp, _, _, _, _ = grid_nerf.render_rays_grid(model, ro, rd, gen, cfg=tcfg, n_samples=16,
                                                  near=0.8, far=2.4)
    assert float(run(7, quiet)[0]) == float(torch.mean((comp - target) ** 2))


def test_adamw_ema_20_steps_match_jax():
    """20 steps of AdamW (weight decay on the tables and the MLP weights,
    not the biases: optax's ndim >= 2 mask) with the lr schedule and the
    EMA, at identical rays and deterministic depths: every parameter and
    EMA leaf rtol 1e-5, atol 1e-5 of the leaf's max (the gradients'
    agreement: Adam's m / sqrt(v) is scale-free, so an entry of small
    gradient carries its f32 rounding into a full-size step)."""
    params, jcfg, model, tcfg = pair(6)
    ro, rd = rays(64, 6)
    target = np.random.RandomState(7).rand(64, 3).astype(np.float32)
    lr, o = 1e-2, dict(decay_steps=10, decay_factor=0.1, weight_decay=1e-2, ema_decay=0.9)
    tx = jtraining.make_optimizer(lr, o["decay_steps"], o["decay_factor"],
                                  weight_decay=o["weight_decay"], ema_decay=o["ema_decay"])
    jl = jax.jit(jax.grad(_jax_loss(jcfg, *map(jnp.asarray, (ro, rd, target)), None)))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    for _ in range(20):
        upd, st = tx.update(jl(jp), st, jp)
        jp = optax.apply_updates(jp, upd)
    opt = make_optimizer(model.parameters(), lr, o["decay_steps"], o["decay_factor"],
                         weight_decay=o["weight_decay"], ema_decay=o["ema_decay"])
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"] > 0 for p in g["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in decayed} == {
        n for n, p in model.named_parameters() if not n.endswith(".bias")}
    tro, trd, ttg = map(torch.from_numpy, (ro, rd, target))
    for _ in range(20):
        opt.zero_grad()
        _port_loss(model, tcfg, tro, trd, ttg, None).backward()
        opt.step()
    names = [n for n, _ in model.named_parameters()]
    for port, want in ((grid_params_to_jax(model), jp),
                       (grid_state_to_jax(dict(zip(names, opt.ema))),
                        jtraining.ema_params_from_opt_state(st))):
        for a, b in zip(jax.tree_util.tree_leaves(port), jax.tree_util.tree_leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


def test_sparsity_grads_match_jax_at_given_points():
    """The grid prior's gradients at the points the JAX grads_fn draws:
    every leaf (the tables through the gather's backward; the colour
    branch none) within 1e-5 of its max."""
    params, jcfg, model, tcfg = pair(8)
    aabb = jnp.asarray([[-1.2, -1.0, -1.1], [1.0, 1.3, 0.9]], jnp.float32)
    key = jax.random.PRNGKey(3)
    js = jtraining.TrainSettings()
    want = jreg.make_sparsity_grad_fn(js, "grid", nerf_cfg=jcfg, lam=1e-2, n_points=512,
                                      aabb=aabb)(jax.tree_util.tree_map(jnp.asarray, params), key)
    pts = aabb[0] + (aabb[1] - aabb[0]) * jax.random.uniform(jax.random.fold_in(key, 0x5FA1),
                                                             (512, 3), jnp.float32)
    fn = make_sparsity_grad_fn(TrainSettings(), "grid", nerf_cfg=tcfg, lam=1e-2, n_points=512,
                               aabb=torch.tensor(np.asarray(aabb)))
    got = fn.at_points(model, torch.tensor(np.asarray(pts)))
    names = [n for n, _ in model.named_parameters()]
    assert all((g is None) == n.startswith("mlp.rgb") for n, g in zip(names, got))
    got_tree = grid_state_to_jax({n: (g if g is not None else torch.zeros_like(p))
                                  for (n, p), g in zip(model.named_parameters(), got)})
    leaves_close(got_tree, want)
    drawn = fn(model, torch.Generator().manual_seed(0))
    assert all((a is None) == (b is None) for a, b in zip(drawn, got))
    with pytest.raises(ValueError, match="GridNeRFConfig"):
        make_sparsity_grad_fn(TrainSettings(), "grid", lam=1e-3)


# Checkpoints and drivers.

TINY_FLAGS = dict(grid_levels=3, grid_base_res=4, grid_max_res=16, grid_table_size=1 << 10,
                  grid_hidden=16, num_freqs_dir=2)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    paths = {}
    for name, ff in (("world", False), ("ff", True)):
        d = synthetic.generate_synthetic_dataset(n_poses=4, h=12, w=12, forward_facing=ff)
        paths[name] = (str(out / f"{name}.npz"), d)
        np.savez(paths[name][0], **d)
    return paths


@pytest.fixture(scope="module")
def jax_grid_ckpt(scenes, tmp_path_factory):
    """A grid checkpoint written by three steps of the JAX trainer (f32)."""
    out = tmp_path_factory.mktemp("jax_grid")
    ck = str(out / "grid.npz")
    jtrain.main(JConfig(model="grid", data_path=scenes["world"][0], ckpt_path=ck,
                        out_dir=str(out / "o"), iters=3, n_rand=32, n_samples=8, chunk=64,
                        resume=False, log_every=3, preview_every=1000, ckpt_every=1000,
                        bf16=False, lr=0.01, **TINY_FLAGS))
    return ck


def test_model_io_renders_jax_grid_checkpoint_like_jax(scenes, jax_grid_ckpt):
    """A JAX-written grid checkpoint through the port's loader: the meta's
    grid entry and box read as written, the GridNeRF restored; the
    loaders' images (bf16 by default on both sides) under the bf16 render
    gates, and f32 renderers over the stored box within 1e-4."""
    from tinynerf_tpu.utils.model_io import load_model_and_renderer as jload

    path = jax_grid_ckpt
    _, d = scenes["world"]
    meta = checkpoint.read_meta(path)["meta"]
    assert meta["model"] == "grid" and len(meta["cfg"]["grid"]["aabb"]) == 6
    kw = dict(H=12, W=12, focal=float(d["focal"]), n_samples=16, chunk=64)
    params, jren, _ = jload(path, **kw)
    model, tren, tmeta = load_model_and_renderer(path, device="cpu", **kw)
    assert isinstance(model, GridNeRF) and tmeta["step"] == 3 and tmeta["model"] == "grid"
    assert model.cfg.aabb == tuple(meta["cfg"]["grid"]["aabb"])
    assert model.cfg.compute_dtype == torch.bfloat16 and model.cfg.level_resolutions() == (4, 8, 16)
    pose = d["poses"][1]
    want = np.asarray(jren(params, jnp.asarray(pose)))
    got = tren(model, torch.from_numpy(pose)).numpy()
    err = np.abs(got - want).max(axis=-1)
    assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3
    f32 = dataclasses.replace(model.cfg, compute_dtype=torch.float32)
    jf32 = jgrid.GridNeRFConfig(**{**TINY, "aabb": f32.aabb}, compute_dtype=jnp.float32)
    img = dict(H=12, W=12, focal=float(d["focal"]), chunk=64, n_samples=16)
    want = np.asarray(jrender.make_grid_image_renderer(grid_cfg=jf32, **img)(params,
                                                                          jnp.asarray(pose)))
    got = render.make_grid_image_renderer(grid_cfg=f32, **img)(model, torch.from_numpy(pose))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def _cfg(path, tmp_path, **kw):
    base = dict(model="grid", data_path=path, device="cpu", iters=4, n_rand=32, n_samples=8,
                log_every=2, preview_every=4, ckpt_every=4, holdout=1, chunk=64, resume=False,
                lr=0.01, out_dir=str(tmp_path / "out"), ckpt_path=str(tmp_path / "ckpt.npz"),
                metrics_path=str(tmp_path / "m.jsonl"), **TINY_FLAGS)
    base.update(kw)
    return Config(**base)


LEVERS = dict(ray_sampling="pool", sigma_noise_std=0.5, sigma_noise_decay_steps=4,
              weight_decay=1e-4, ema_decay=0.9, lr_decay_steps=8, sigma_sparsity=1e-3,
              sigma_sparsity_points=64)


def test_train_grid_trains_resumes_evals_and_gifs(scenes, tmp_path, capsys):
    """`train --model grid` with the levers on (the fused flags at their
    default, on: the family takes the eager route): the echo lines, the
    JAX driver's meta (the grid entry with the capture's box), a resume
    from step 2 that ends bit-identical to the uninterrupted run (EMA
    too), `eval` of the checkpoint and its EMA twin, `make_gif --depth`;
    the JAX trainer resumes the port's checkpoint (optax's tree)."""
    path, d = scenes["world"]
    full = _cfg(path, tmp_path / "full", **LEVERS)
    assert full.fused and full.fused_train
    res = train.main(full)
    out = capsys.readouterr().out
    assert "[model] grid: levels=(4, 8, 16) dense=2/3 aabb=" in out
    assert "grid family: the encoding on kernels/grid_encode.py" in out
    assert "none of K1-K7" in out and "fused fwd+bwd" not in out
    assert isinstance(res["model"], GridNeRF) and np.isfinite(res["final_psnr"])
    assert np.isfinite(res["eval"]["psnr_mean"]) and np.isfinite(res["eval_ema"]["psnr_mean"])
    meta = checkpoint.read_meta(full.ckpt_path)["meta"]
    g = meta["cfg"]["grid"]
    assert meta["model"] == "grid" and g["levels"] == 3 and g["table_size"] == 1024
    ro, rd = zip(*(get_rays(12, 12, float(d["focal"]), torch.from_numpy(p)) for p in d["poses"]))
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays

    box = aabb_from_rays(torch.stack(ro), torch.stack(rd), 2.0, 6.0).numpy().reshape(6)
    np.testing.assert_array_equal(np.asarray(g["aabb"], np.float32), box)
    part = _cfg(path, tmp_path / "part", **{**LEVERS, "iters": 2})
    train.main(part)
    capsys.readouterr()
    train.main(_cfg(path, tmp_path / "part", **{**LEVERS, "resume": True}))
    assert "[resume] loaded" in capsys.readouterr().out
    for suffix in ("", ".ema.npz"):
        a, b = (GridNeRF(Config(**TINY_FLAGS).grid_cfg()) for _ in range(2))
        checkpoint.restore_params(full.ckpt_path + suffix, a)
        checkpoint.restore_params(part.ckpt_path + suffix, b)
        for (n, x), y in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(x, y), (suffix, n)
    ev = eval_mod.main(eval_mod.EvalConfig(ckpt_path=full.ckpt_path, data_path=path, views=2,
                                           save_depth=True, out_dir=str(tmp_path / "ev"),
                                           device="cpu"))
    assert np.isfinite(ev["psnr_mean"]) and (tmp_path / "ev" / "depth_000.png").exists()
    ema = eval_mod.main(eval_mod.EvalConfig(ckpt_path=full.ckpt_path, data_path=path, views=1,
                                            ema=True, out_dir=str(tmp_path / "eve"),
                                            device="cpu"))
    assert np.isfinite(ema["psnr_mean"])
    frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=full.ckpt_path, data_path=path, n_frames=2,
                                            depth=True, out_path=str(tmp_path / "d.gif"),
                                            device="cpu"))
    assert frames.shape == (2, 12, 12, 3) and frames.dtype == np.uint8
    jtrain.main(JConfig(model="grid", data_path=path, ckpt_path=full.ckpt_path,
                        out_dir=str(tmp_path / "jout"), iters=6, n_rand=32, n_samples=8, chunk=64,
                        log_every=2, holdout=1, preview_every=1000, ckpt_every=1000, lr=0.01,
                        **LEVERS, **TINY_FLAGS))
    with np.load(full.ckpt_path) as z:
        assert int(z["step"]) == 6


def test_port_checkpoint_restores_in_jax_with_equal_trees(tmp_path):
    """A port-written grid checkpoint (AdamW, schedule, EMA) restored by the
    JAX package's restore_checkpoint against its own optimizer: the same
    param and optax state trees; the leaves as written."""
    _, _, model, tcfg = pair(9)
    o = dict(decay_steps=8, weight_decay=1e-2, ema_decay=0.9)
    opt = make_optimizer(model.parameters(), 1e-2, o["decay_steps"], weight_decay=o["weight_decay"],
                         ema_decay=o["ema_decay"])
    ro, rd = map(torch.from_numpy, rays(32, 9))
    for _ in range(2):
        opt.zero_grad()
        _port_loss(model, tcfg, ro, rd, torch.ones(32, 3), None).backward()
        opt.step()
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, model, opt, 2, meta={"model": "grid"})
    jparams = jax.tree_util.tree_map(jnp.asarray, jgrid.init_grid_nerf(
        jax.random.PRNGKey(0), jgrid.GridNeRFConfig(**TINY)))
    tx = jtraining.make_optimizer(1e-2, o["decay_steps"], weight_decay=o["weight_decay"],
                                  ema_decay=o["ema_decay"])
    jp, st, step, meta = jckpt.restore_checkpoint(path, jparams, tx.init(jparams))
    assert step == 2 and meta == {"model": "grid"}
    info = checkpoint.read_meta(path)
    assert info["param_struct"] == str(jax.tree_util.tree_structure(jp))
    assert info["opt_struct"] == str(jax.tree_util.tree_structure(st))
    leaves_close(grid_params_to_jax(model), jp, scale=0)
    names = [n for n, _ in model.named_parameters()]
    leaves_close(grid_state_to_jax(dict(zip(names, opt.ema))),
                 jtraining.ema_params_from_opt_state(st), scale=0)


def test_grid_leaf_order_past_ten_levels(tmp_path):
    """Twelve levels: JAX sorts l10 and l11 before l2; a port checkpoint
    round-trips through both packages' leaf orders."""
    kw = dict(n_levels=12, base_res=2, max_res=24, table_size=1 << 8, hidden=8, geo_features=3,
              num_freqs_dir=1)
    model = GridNeRF(GridNeRFConfig(**kw), generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "g12.npz")
    checkpoint.save_params(path, model, 5)
    jparams = jgrid.init_grid_nerf(jax.random.PRNGKey(0), jgrid.GridNeRFConfig(**kw))
    got, step, _ = jckpt.restore_params(path, jparams)
    assert step == 5
    leaves_close(grid_params_to_jax(model), got, scale=0)
    back = GridNeRF(GridNeRFConfig(**kw))
    checkpoint.restore_params(path, back)
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(), model.parameters()))


@pytest.mark.parametrize("name", ["world", "ff"])
def test_train_grid_under_ndc_and_the_world_box(scenes, tmp_path, name):
    """--ndc: the NDC cube as the grid's box (persisted); without it the
    capture's box; finite losses either way, fused flags off too."""
    path, _ = scenes[name]
    cfg = _cfg(path, tmp_path, ndc=name == "ff", fused=False, fused_train=False)
    res = train.main(cfg)
    assert np.isfinite(res["final_psnr"])
    g = checkpoint.read_meta(cfg.ckpt_path)["meta"]["cfg"]["grid"]
    if name == "ff":
        assert g["aabb"] == [-1.0] * 3 + [1.0] * 3
    else:
        assert g["aabb"] != [-1.0] * 3 + [1.0] * 3


def test_train_grid_refusals(tmp_path):
    """The JAX package's two refusals for the family, with its messages."""
    with pytest.raises(ValueError, match="nerf-family sampler"):
        train.main(Config(model="grid", proposal="occupancy", device="cpu",
                          out_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="not implemented for --model grid"):
        train.main(Config(model="grid", data_parallel=True, sample_parallel=2, device="cpu",
                          out_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown model"):
        train.main(Config(model="mlp", device="cpu", out_dir=str(tmp_path)))


def test_config_grid_fields_and_cfg_match_jax():
    j, t = JConfig(), Config()
    for f in ("grid_levels", "grid_features", "grid_base_res", "grid_max_res", "grid_table_size",
              "grid_hidden", "grid_encode_impl"):
        assert getattr(t, f) == getattr(j, f), f
    box = np.asarray([[-1.5, -2.25, -3.0], [1.0, 2.0, 0.5]], np.float32)
    for bf16 in (True, False):
        jg, tg = JConfig(bf16=bf16).grid_cfg(aabb=box), Config(bf16=bf16).grid_cfg(aabb=box)
        assert tg.aabb == jg.aabb and tg.level_resolutions() == jg.level_resolutions()
        assert tg.compute_dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert (tg.n_levels, tg.features, tg.table_size, tg.hidden, tg.num_freqs_dir) == (
            jg.n_levels, jg.features, jg.table_size, jg.hidden, jg.num_freqs_dir)
    assert Config().grid_cfg().aabb == JConfig().grid_cfg().aabb


def test_train_grid_data_parallel_on_two_ranks(scenes, tmp_path):
    """`--model grid --data-parallel` on two gloo ranks (torch.distributed.run):
    both exit 0 with bit-identical parameters and launch no kernel."""
    path, _ = scenes["world"]
    flags = []
    for k, v in TINY_FLAGS.items():
        flags += [f"--{k.replace('_', '-')}", str(v)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "tinynerf_tpu_torch.train", "--model", "grid", "--device", "cpu",
           "--data-parallel", "--iters", "3", "--n-rand", "32", "--n-samples", "8",
           "--log-every", "3", "--holdout", "1", "--chunk", "64", "--lr", "0.01",
           "--sigma-noise-std", "0.5", "--no-resume", "--data-path", path,
           "--ckpt-path", str(tmp_path / "ckpt.npz"), "--out-dir", str(tmp_path / "out"), *flags]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    lines = [ln for ln in out.splitlines() if "parameter digest" in ln]
    digests = {ln.split("parameter digest ")[1].split(",")[0] for ln in lines}
    assert len(lines) == 2 and len(digests) == 1, out
    launches = [json.loads(ln.split("kernel launches ")[1]) for ln in lines]
    assert all(n == 0 for counts in launches for n in counts.values()), launches
