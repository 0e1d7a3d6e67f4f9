"""Port parity for ROADMAP item 11, the occupancy proposal: the density
grid, the segment alphas and the grid-proposed depths, the single-MLP
pass's gradients, the occupancy image, JAX-written occupancy checkpoints
(world and NDC), and the port's trainer (--proposal occupancy learns and
resumes; --data-parallel on two gloo ranks keeps the replicas equal), on
the CPU.

f32 MLP of L 4, L_dir 2, hidden 32, depth 3, skip 2, rgb_hidden 16, its
sigma bias raised so that rays gather opacity; grids of 16^3 cells, 32
samples per ray over 16 segments, R <= 256. The JAX occupancy reference
is its fused=False path. Inputs come from numpy with a seed; weights are
carried across with nerf_params_from_jax.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tinynerf_tpu import render as jrender
from tinynerf_tpu import train as jtrain
from tinynerf_tpu.config import Config as JConfig
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops import occupancy as jocc
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu.ops.volume import volume_render as jvolume_render
from tinynerf_tpu_torch import render, synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_from_jax
from tinynerf_tpu_torch.ops import occupancy
from tinynerf_tpu_torch.ops.rays import get_rays
from tinynerf_tpu_torch.training import TrainSettings, make_optimizer
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

NERF = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
RES, SEG, S = 16, 16, 32


@pytest.fixture(autouse=True)
def _grad_enabled():
    # tests/test_torch_parity.py turns autograd off for its whole worker.
    with torch.enable_grad():
        yield


def pair(seed=0):
    """JAX {'fine': mlp} params and a port NeRF(parts=("fine",)) holding the
    same weights, f32, the sigma bias raised by 1."""
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **NERF)
    mlp = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf_mlp(jax.random.PRNGKey(seed), jcfg))
    mlp["sigma"]["b"] = mlp["sigma"]["b"] + np.float32(1.0)
    params = {"fine": mlp}
    tcfg = NeRFConfig(compute_dtype=torch.float32, **NERF)
    model = NeRF(tcfg, parts=("fine",))
    model.load_state_dict(nerf_params_from_jax(params))
    return params, jcfg, model, tcfg


def scene_rays(n, seed):
    """n rays of a hemisphere pose (inward-facing, near 2, far 6) and the
    box of their [near, far] segments."""
    pose = synthetic.hemisphere_poses(8)[seed % 8]
    ro, rd = get_rays(24, 24, 30.0, torch.from_numpy(pose))
    idx = np.random.RandomState(seed).choice(24 * 24, n, replace=False)
    ro, rd = ro[idx].numpy(), rd[idx].numpy()
    aabb = np.asarray(jocc.aabb_from_rays(jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0))
    return ro, rd, aabb


def t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_density_grid_matches_jax():
    """Cell-centre sigma, rtol 1e-5; a jittered grid stays a grid of the
    same MLP (its points inside their cells: sigma within the spread of
    the neighbours' values) and replays from its generator."""
    params, jcfg, model, tcfg = pair(1)
    _, _, aabb = scene_rays(64, 1)
    want = np.asarray(jocc.density_grid(params["fine"], jcfg, resolution=RES, aabb=jnp.asarray(aabb)))
    got = occupancy.density_grid(model.fine, tcfg, resolution=RES, aabb=torch.from_numpy(aabb))
    assert got.shape == (RES, RES, RES) and not got.requires_grad
    assert (want > 0).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    def jittered(seed):
        return occupancy.density_grid(model.fine, tcfg, resolution=RES, aabb=torch.from_numpy(aabb),
                                      generator=torch.Generator().manual_seed(seed))

    a = jittered(3)
    assert torch.equal(a, jittered(3)) and not torch.equal(a, jittered(4))
    assert float((a - got).abs().mean()) < float((got - got.roll(1, 0)).abs().mean())


def test_default_boxes_match_jax():
    for h in (3.0, 1.0):
        np.testing.assert_array_equal(occupancy.default_aabb(h).numpy(), np.asarray(jocc.default_aabb(h)))


def test_segment_alphas_match_jax_with_few_flipped_cells():
    """A grid of distinct random densities, 256 rays x 16 segments: the
    edges to 1 ulp, the alphas equal where both read the same cell, and
    the fraction of (ray, segment) reads that land in another cell (a
    midpoint within f32 rounding of a cell face) at most 1e-3."""
    ro, rd, aabb = scene_rays(256, 2)
    grid = np.random.RandomState(2).uniform(0.5, 50.0, (RES, RES, RES)).astype(np.float32)
    wa, we = jocc.ray_segment_alphas(jnp.asarray(grid), jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0,
                                     n_segments=SEG, aabb=jnp.asarray(aabb))
    ga, ge = occupancy.ray_segment_alphas(*t(grid, ro, rd), 2.0, 6.0, n_segments=SEG,
                                          aabb=torch.from_numpy(aabb))
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1.2e-7, atol=0)
    diff = np.abs(ga.numpy() - np.asarray(wa))
    flipped = diff > 1e-5
    assert flipped.mean() <= 1e-3
    assert diff[~flipped].max() <= 1e-6
    assert (np.asarray(wa) > 0).mean() > 0.3  # most reads inside the box


def test_occupancy_samples_deterministic_match_jax():
    """randomized=False, at the sample_pdf port test's tolerance: 1e-5,
    except where a u falls in a bin of small pdf (< 1e-3, the floor's
    segments), which must stay in its bin."""
    params, jcfg, model, tcfg = pair(2)
    ro, rd, aabb = scene_rays(128, 3)
    grid = np.asarray(jocc.density_grid(params["fine"], jcfg, resolution=RES, aabb=jnp.asarray(aabb)))
    want = np.asarray(jocc.occupancy_samples(jnp.asarray(grid), jnp.asarray(ro), jnp.asarray(rd),
                                             2.0, 6.0, S, n_segments=SEG, aabb=jnp.asarray(aabb)))
    got = occupancy.occupancy_samples(*t(grid, ro, rd), 2.0, 6.0, S, n_segments=SEG,
                                      aabb=torch.from_numpy(aabb)).numpy()
    assert got.shape == (128, S) and (np.diff(got, axis=1) >= 0).all()
    alphas, edges = jocc.ray_segment_alphas(jnp.asarray(grid), jnp.asarray(ro), jnp.asarray(rd),
                                            2.0, 6.0, n_segments=SEG, aabb=jnp.asarray(aabb))
    w = np.asarray(alphas) + 1e-2 + 1e-5
    pdf = w / w.sum(axis=1, keepdims=True)
    edges = np.asarray(edges)
    k = np.clip(np.searchsorted(edges, want, side="right") - 1, 0, SEG - 1)
    small = np.take_along_axis(pdf, k, axis=1) < 1e-3
    assert small.mean() < 0.2
    np.testing.assert_allclose(got[~small], want[~small], atol=1e-5)
    lo, hi = edges[k], edges[k + 1]
    assert bool(((got >= lo - 1e-5) & (got <= hi + 1e-5))[small].all())


def test_occupancy_samples_randomized_statistics():
    """Sorted, inside [near, far], replayable from the generator; mapped
    through each ray's segment CDF the draws are uniform: the deciles'
    shares within 6 standard errors of 0.1."""
    params, jcfg, model, tcfg = pair(3)
    ro, rd, aabb = scene_rays(256, 4)
    grid = occupancy.density_grid(model.fine, tcfg, resolution=RES, aabb=torch.from_numpy(aabb))
    kw = dict(n_segments=SEG, aabb=torch.from_numpy(aabb), randomized=True)
    ro_t, rd_t = t(ro, rd)
    z = occupancy.occupancy_samples(grid, ro_t, rd_t, 2.0, 6.0, S,
                                    generator=torch.Generator().manual_seed(5), **kw)
    again = occupancy.occupancy_samples(grid, ro_t, rd_t, 2.0, 6.0, S,
                                        generator=torch.Generator().manual_seed(5), **kw)
    assert torch.equal(z, again)
    assert bool((z >= 2.0).all() and (z <= 6.0).all() and (z[:, 1:] >= z[:, :-1]).all())
    with pytest.raises(ValueError, match="generator"):
        occupancy.occupancy_samples(grid, ro_t, rd_t, 2.0, 6.0, S, **kw)
    alphas, edges = occupancy.ray_segment_alphas(grid, ro_t, rd_t, 2.0, 6.0, n_segments=SEG,
                                                 aabb=torch.from_numpy(aabb))
    w = (alphas + 1e-2 + 1e-5).double()
    cdf = torch.cat([torch.zeros(256, 1, dtype=torch.float64), torch.cumsum(w / w.sum(1, keepdim=True), 1)], 1)
    e = edges.double()
    k = torch.clamp(torch.searchsorted(e.contiguous(), z.double().contiguous(), right=True) - 1, 0, SEG - 1)
    frac = (z.double() - e[k]) / (e[k + 1] - e[k])
    u = torch.gather(cdf, 1, k) + frac * (torch.gather(cdf, 1, k + 1) - torch.gather(cdf, 1, k))
    n = u.numel()
    share = torch.histc(u.float(), bins=10, min=0.0, max=1.0) / n
    assert float((share - 0.1).abs().max()) < 6 * (0.09 / n) ** 0.5


def _jax_pass_grads(params, jcfg, ro, rd, target, z):
    """jax.grad of the JAX package's single-MLP occupancy loss with the
    depths z given (make_occupancy_loss's body on deterministic samples)."""
    def loss(p):
        R, n = z.shape
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        x_enc = jenc(pts.reshape(-1, 3), num_freqs=jcfg.num_freqs)
        vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        d_enc = jnp.repeat(jenc(vd, num_freqs=jcfg.num_freqs_dir), n, axis=0)
        rgb, sigma = jnerf.apply_nerf_mlp(p["fine"], x_enc, d_enc, jcfg)
        comp, _, _, _ = jvolume_render(rgb.reshape(R, n, 3), sigma.reshape(R, n), z, rd,
                                       white_bkgd=True)
        return jnp.mean((comp - target) ** 2)

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("fused", [False, True])
def test_occupancy_pass_grads_match_jax_at_the_same_depths(monkeypatch, fused):
    """make_occupancy_loss (autograd) and make_occupancy_fused_grad_fn (K6's
    plain version on the CPU), their sampler handed the JAX package's
    grid-proposed depths: loss to 1e-6, each leaf within 1e-5 of its max
    against jax.grad of the JAX loss."""
    params, jcfg, model, tcfg = pair(4)
    ro, rd, aabb = scene_rays(96, 5)
    target = np.random.RandomState(6).rand(96, 3).astype(np.float32)
    grid = jocc.density_grid(params["fine"], jcfg, resolution=RES, aabb=jnp.asarray(aabb))
    z = np.asarray(jocc.occupancy_samples(grid, jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0, S,
                                          n_segments=SEG, aabb=jnp.asarray(aabb)))
    want_loss, want = _jax_pass_grads(params, jcfg, *(jnp.asarray(a) for a in (ro, rd, target, z)))
    seen = []

    def given(*a, **kw):
        seen.append(kw["randomized"])
        return torch.from_numpy(z)

    monkeypatch.setattr(occupancy, "occupancy_samples", given)
    s = TrainSettings(n_rand=96, n_samples=S)
    kw = dict(n_segments=SEG, aabb=torch.from_numpy(aabb))
    ro_t, rd_t, tgt = t(ro, rd, target)
    gen = torch.Generator().manual_seed(0)
    if fused:
        loss, _ = occupancy.make_occupancy_fused_grad_fn(tcfg, **kw)(
            model, None, ro_t, rd_t, tgt, gen, s)
    else:
        value, _ = occupancy.make_occupancy_loss(tcfg, **kw)(model, None, ro_t, rd_t, tgt, gen, s)
        value.backward()
        loss = value.detach()
    assert seen == [True]
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-6)
    ref = nerf_params_from_jax(jax.tree_util.tree_map(np.asarray, want))
    for name, p in model.named_parameters():
        w = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5 * float(np.abs(w).max()), err_msg=name)


def test_occupancy_fused_grad_fn_equals_the_eager_loss_on_one_generator():
    """The fused twin and the eager loss draw the same depths and
    sigma-noise from one generator: the same loss and gradients (K6's
    plain version against autograd), the sigma-noise included."""
    params, jcfg, model, tcfg = pair(5)
    ro, rd, aabb = scene_rays(64, 6)
    target = np.random.RandomState(7).rand(64, 3).astype(np.float32)
    grid = occupancy.density_grid(model.fine, tcfg, resolution=RES, aabb=torch.from_numpy(aabb))
    s = TrainSettings(n_rand=64, n_samples=S, sigma_noise_std=0.5)
    kw = dict(n_segments=SEG, aabb=torch.from_numpy(aabb))
    ro_t, rd_t, tgt = t(ro, rd, target)
    l_f, _ = occupancy.make_occupancy_fused_grad_fn(tcfg, **kw)(
        model, grid, ro_t, rd_t, tgt, torch.Generator().manual_seed(9), s, noise_scale=0.5)
    g_f = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    value, m = occupancy.make_occupancy_loss(tcfg, **kw)(
        model, grid, ro_t, rd_t, tgt, torch.Generator().manual_seed(9), s, noise_scale=0.5)
    value.backward()
    assert abs(float(l_f) - float(value)) <= 1e-6 * float(value)
    assert abs(float(m["psnr"]) + 10 * np.log10(float(value))) < 1e-4
    for a, p in zip(g_f, model.parameters()):
        np.testing.assert_allclose(a.numpy(), p.grad.numpy(), atol=1e-5 * float(p.grad.abs().max()))


@pytest.mark.parametrize("aux", [False, True])
def test_occupancy_image_matches_jax(aux):
    """make_occupancy_image_renderer against the JAX package's, f32, 12 x
    12, grid 16^3, 32 samples: the colour (eager, and the fused route's K5
    plain version) at the hierarchical render's tolerance 1e-4; aux: the
    acc channel, and the depth channel where acc >= 0.1."""
    params, jcfg, model, tcfg = pair(6)
    pose = synthetic.hemisphere_poses(8)[3]
    _, _, aabb = scene_rays(64, 3)
    kw = dict(H=12, W=12, focal=15.0, chunk=64, n_samples=S, resolution=RES, n_segments=SEG,
              aux=aux)
    want = np.asarray(jrender.make_occupancy_image_renderer(
        nerf_cfg=jcfg, aabb=jnp.asarray(aabb), **kw)(params, jnp.asarray(pose)))
    for fused in (False, True):
        got = render.make_occupancy_image_renderer(
            nerf_cfg=tcfg, aabb=torch.from_numpy(aabb), use_fused=fused, **kw)(
            model, torch.from_numpy(pose)).numpy()
        assert got.shape == (12, 12, 3)
        if aux:
            np.testing.assert_allclose(got[..., 1], want[..., 1], atol=1e-4)
            mask = want[..., 1] >= 0.1
            assert mask.mean() > 0.3
            np.testing.assert_allclose(got[..., 0][mask], want[..., 0][mask], atol=1e-4)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4)


# Checkpoints and drivers.

TINY_CFG = dict(num_freqs=4, num_freqs_dir=2, hidden=32, nerf_depth=3, nerf_skip_at=2,
                rgb_hidden=16)


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
def jax_occ_ckpts(scenes, tmp_path_factory):
    """Occupancy checkpoints written by three steps of the JAX trainer: on
    the inward-facing scene and, with --ndc, on the forward-facing one."""
    out = tmp_path_factory.mktemp("jax_occ")
    ckpts = {}
    for name, ndc in (("world", False), ("ff", True)):
        ck = str(out / f"{name}.npz")
        jtrain.main(JConfig(model="nerf", proposal="occupancy", ndc=ndc, data_path=scenes[name][0],
                            ckpt_path=ck, out_dir=str(out / name), iters=3, n_rand=32,
                            n_samples=8, n_fine=8, chunk=64, resume=False, log_every=3,
                            preview_every=1000, ckpt_every=1000, bf16=False, **TINY_CFG))
        ckpts[name] = ck
    return ckpts


@pytest.mark.parametrize("name", ["world", "ff"])
def test_model_io_renders_jax_occupancy_checkpoint_like_jax(scenes, jax_occ_ckpts, name):
    """A JAX-written occupancy checkpoint (and one under --ndc): the meta's
    proposal, ndc and occ_aabb read as written, the single MLP restored,
    the loader's images (bf16 by default on both sides) under the bf16
    render gates, and f32 renderers over the stored box within 1e-4."""
    from tinynerf_tpu.utils.model_io import load_model_and_renderer as jload

    path = jax_occ_ckpts[name]
    _, d = scenes[name]
    meta = checkpoint.read_meta(path)["meta"]["cfg"]
    assert meta["proposal"] == "occupancy" and meta["ndc"] is (name == "ff")
    focal = float(d["focal"])
    kw = dict(H=12, W=12, focal=focal, n_samples=8, chunk=64)
    params, jren, _ = jload(path, **kw)
    model, tren, tmeta = load_model_and_renderer(path, fused=False, device="cpu", **kw)
    assert model.parts == ("fine",) and tmeta["cfg"]["occ_aabb"] == meta["occ_aabb"]
    pose = d["poses"][1]
    want = np.asarray(jren(params, jnp.asarray(pose)))
    got = tren(model, torch.from_numpy(pose)).numpy()
    err = np.abs(got - want).max(axis=-1)
    assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3
    near, far = (0.0, 1.0) if name == "ff" else (2.0, 6.0)
    img = dict(H=12, W=12, focal=focal, chunk=64, n_samples=16, near=near, far=far,
               ndc=name == "ff")
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **NERF)
    want = np.asarray(jrender.make_occupancy_image_renderer(
        nerf_cfg=jcfg, aabb=jnp.asarray(meta["occ_aabb"], jnp.float32), **img)(
        params, jnp.asarray(pose)))
    got = render.make_occupancy_image_renderer(
        nerf_cfg=dataclasses.replace(model.cfg, compute_dtype=torch.float32),
        aabb=torch.tensor(meta["occ_aabb"]), **img)(model, torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _cfg(path, tmp_path, **kw):
    base = dict(model="nerf", proposal="occupancy", data_path=path, device="cpu", iters=4,
                n_rand=32, n_samples=8, n_fine=8, log_every=2, preview_every=4, ckpt_every=4,
                holdout=1, chunk=64, resume=False, out_dir=str(tmp_path / "out"),
                ckpt_path=str(tmp_path / "ckpt.npz"), metrics_path=str(tmp_path / "m.jsonl"),
                **TINY_CFG)
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("fused_train", [True, False])
def test_train_occupancy_runs_writes_and_resumes_like_an_uninterrupted_run(scenes, tmp_path,
                                                                         fused_train, capsys):
    """`train --proposal occupancy`: a NeRF(parts=("fine",)), the JAX
    driver's meta (proposal, ndc, occ_aabb = the capture's box), held-out
    eval, and a resume from step 2 that ends bit-identical to the
    uninterrupted run (the grid is rebuilt from the parameters at each
    block's start)."""
    path, _ = scenes["world"]
    full = _cfg(path, tmp_path / "full", fused_train=fused_train, sigma_noise_std=0.5)
    res = train.main(full)
    assert isinstance(res["model"], NeRF) and res["model"].parts == ("fine",)
    assert np.isfinite(res["final_psnr"]) and np.isfinite(res["eval"]["psnr_mean"])
    out = capsys.readouterr().out
    assert "occupancy proposal" in out
    meta = checkpoint.read_meta(full.ckpt_path)["meta"]["cfg"]
    assert meta["proposal"] == "occupancy" and meta["ndc"] is False
    d = np.load(path)
    ro, rd = zip(*(get_rays(12, 12, float(d["focal"]), torch.from_numpy(p)) for p in d["poses"]))
    box = occupancy.aabb_from_rays(torch.stack(ro), torch.stack(rd), 2.0, 6.0)
    np.testing.assert_allclose(np.asarray(meta["occ_aabb"]), box.numpy(), rtol=1e-6)
    part = _cfg(path, tmp_path / "part", fused_train=fused_train, sigma_noise_std=0.5, iters=2)
    train.main(part)
    capsys.readouterr()
    train.main(_cfg(path, tmp_path / "part", fused_train=fused_train, sigma_noise_std=0.5,
                    resume=True))
    assert "[resume] loaded" in capsys.readouterr().out
    a = NeRF(NeRFConfig(**NERF), parts=("fine",))
    b = NeRF(NeRFConfig(**NERF), parts=("fine",))
    checkpoint.restore_params(full.ckpt_path, a)
    checkpoint.restore_params(part.ckpt_path, b)
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n


def test_train_occupancy_ndc_and_jax_resumes_it(scenes, tmp_path):
    """--proposal occupancy --ndc: the NDC cube as the grid's box; the JAX
    trainer resumes the port's checkpoint (optax state included)."""
    path, _ = scenes["ff"]
    cfg = _cfg(path, tmp_path, ndc=True)
    train.main(cfg)
    meta = checkpoint.read_meta(cfg.ckpt_path)["meta"]["cfg"]
    assert meta["ndc"] is True and meta["occ_aabb"] == [[-1.0] * 3, [1.0] * 3]
    jtrain.main(JConfig(model="nerf", proposal="occupancy", ndc=True, data_path=path,
                        ckpt_path=cfg.ckpt_path, out_dir=str(tmp_path / "jout"), iters=6,
                        n_rand=32, n_samples=8, n_fine=8, chunk=64, log_every=2, holdout=1,
                        preview_every=1000, ckpt_every=1000, **TINY_CFG))
    assert checkpoint.read_meta(cfg.ckpt_path)["meta"]["cfg"]["proposal"] == "occupancy"
    with np.load(cfg.ckpt_path) as z:
        assert int(z["step"]) == 6


def _occ_blocks(mesh, fused, blocks=3, steps=10, lr=5e-3):
    """The occupancy block on a tiny inward-facing scene: the block means."""
    d = synthetic.generate_synthetic_dataset(n_poses=3, h=12, w=12)
    ro, rd = zip(*(get_rays(12, 12, float(d["focal"]), torch.from_numpy(p)) for p in d["poses"]))
    ro, rd = torch.stack(ro), torch.stack(rd)
    pixels = torch.from_numpy(d["images"]).reshape(3, -1, 3)
    cfg = NeRFConfig(compute_dtype=torch.float32, **NERF)
    model = NeRF(cfg, parts=("fine",), generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), lr)
    s = TrainSettings(n_rand=64, n_samples=16, lr=lr)
    block = occupancy.make_occupancy_train_block(
        s, steps, cfg, resolution=RES, n_segments=SEG, fused=fused, mesh=mesh,
        aabb=occupancy.aabb_from_rays(ro, rd, 2.0, 6.0))
    means = [float(block(model, opt, 1, b * steps, ro, rd, pixels)["loss"].mean())
             for b in range(blocks)]
    return [p.detach().clone() for p in model.parameters()], means


@pytest.mark.parametrize("fused", [True, False])
def test_occupancy_block_learns(fused):
    _, means = _occ_blocks(None, fused)
    assert np.isfinite(means).all() and means[-1] < means[0], means


def _dp_worker(rank, world, init, out):
    from tinynerf_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    assert initialize_distributed(init_method=init, world_size=world, rank=rank, device_type="cpu")
    res = {f: _occ_blocks(make_mesh(), f, blocks=2, steps=5) for f in (True, False)}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_occupancy_data_parallel_two_ranks_keep_replicas_equal(tmp_path):
    """make_occupancy_train_block on a data mesh of two gloo ranks: each
    rank draws its own rays, the gradients are mean-reduced, and every
    rank ends with bit-identical parameters and the same (averaged)
    losses, fused and eager."""
    init = f"file://{tmp_path / 'store'}"
    ctx = mp.spawn(_dp_worker, args=(2, init, str(tmp_path)), nprocs=2, join=False)
    deadline = time.time() + 300  # a hung collective fails the test, not the suite
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("2 ranks did not finish in 300 s")
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    for fused in (True, False):
        assert all(torch.equal(a, b) for a, b in zip(r0[fused][0], r1[fused][0]))
        assert r0[fused][1] == r1[fused][1] and np.isfinite(r0[fused][1]).all()
    with pytest.raises(ValueError, match="data-parallel meshes only"):
        from tinynerf_tpu_torch.parallel.mesh import Mesh

        occupancy.make_occupancy_train_block(TrainSettings(), 1, NeRFConfig(), mesh=Mesh(1, 2, 0))


def test_meta_json_round_trips_the_box(scenes, tmp_path):
    """The box is stored as plain floats (JSON), the JAX driver's
    np.asarray(occ_aabb).tolist()."""
    path, _ = scenes["world"]
    cfg = _cfg(path, tmp_path, iters=2, holdout=0)
    train.main(cfg)
    raw = json.loads(str(np.load(cfg.ckpt_path)["meta"]))["meta"]["cfg"]["occ_aabb"]
    assert isinstance(raw, list) and all(isinstance(v, float) for row in raw for v in row)
