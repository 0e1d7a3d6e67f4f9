"""Port parity for ROADMAP item 10: NDC rays, the forward-facing capture,
the packed depth/acc (aux) rendering and NDC colour images, against the
JAX package on the CPU; then the drivers that use them (train --ndc,
eval --save-depth, make_gif --depth) and JAX-written NDC checkpoints.

f32 throughout but where a driver runs its bf16 default. TinyNeRF at
hidden 32, depth 3; the NeRF at L 4, L_dir 2, hidden 32, depth 3, skip 2,
rgb_hidden 16; images of 12 x 12. Inputs come from numpy with a seed;
weights are carried across with params_from_jax / nerf_params_from_jax.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu import render as jrender
from tinynerf_tpu import synthetic as jsynthetic
from tinynerf_tpu import train as jtrain
from tinynerf_tpu.config import Config as JConfig
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JTinyConfig
from tinynerf_tpu.models.tinynerf import init_tinynerf
from tinynerf_tpu.ops import rays as jrays
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import make_gif as gif_mod
from tinynerf_tpu_torch import render, synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_from_jax
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax
from tinynerf_tpu_torch.ops.rays import get_rays, ndc_rays
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

NERF = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
TINY = dict(hidden=32, depth=3, skip_at=1)
IMG = dict(H=12, W=12, focal=15.0)


def _opaque(mlp_params, bias):
    """Raise the sigma head's bias so that the rays of a random MLP gather
    opacity (a random init's rays are nearly empty, their aux depth
    undefined)."""
    mlp_params["sigma"]["b"] = mlp_params["sigma"]["b"] + np.float32(bias)


def tiny_pair(seed):
    jcfg = JTinyConfig(in_dim=3 + 6 * 4, compute_dtype=jnp.float32, **TINY)
    params = jax.tree_util.tree_map(np.asarray, init_tinynerf(jax.random.PRNGKey(seed), jcfg))
    _opaque(params, 0.5)
    model = TinyNeRF(TinyNeRFConfig(in_dim=27, compute_dtype=torch.float32, **TINY))
    model.load_state_dict(params_from_jax(params))
    return params, jcfg, model, model.cfg


def nerf_pair(seed):
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **NERF)
    params = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf(jax.random.PRNGKey(seed), jcfg))
    for part in ("coarse", "fine"):
        _opaque(params[part], 2.0)
    model = NeRF(NeRFConfig(compute_dtype=torch.float32, **NERF))
    model.load_state_dict(nerf_params_from_jax(params))
    return params, jcfg, model, model.cfg


def ff_pose(i=0):
    return synthetic.forward_facing_poses(4)[i]


def test_ndc_rays_match_jax():
    """Every ray of a forward-facing pose (dz < 0), and a batch of random
    ones, to rtol 1e-6."""
    ro, rd = get_rays(IMG["H"], IMG["W"], IMG["focal"], torch.from_numpy(ff_pose(1)))
    rng = np.random.RandomState(0)
    rd2 = rng.randn(64, 3).astype(np.float32)
    rd2[:, 2] = -np.abs(rd2[:, 2]) - 0.2
    ro2 = (rng.randn(64, 3) * 0.3).astype(np.float32) + [0.0, 0.0, 2.0]
    for o, d in ((ro.numpy(), rd.numpy()), (ro2.astype(np.float32), rd2)):
        got = ndc_rays(IMG["H"], IMG["W"], IMG["focal"], 1.0, torch.from_numpy(o), torch.from_numpy(d))
        want = jrays.ndc_rays(IMG["H"], IMG["W"], IMG["focal"], 1.0, jnp.asarray(o), jnp.asarray(d))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_forward_facing_poses_bit_identical():
    for n, seed in ((20, 0), (7, 3)):
        want = jsynthetic.forward_facing_poses(n, seed=seed)
        got = synthetic.forward_facing_poses(n, seed=seed)
        assert got.dtype == want.dtype and got.shape == (n, 4, 4)
        np.testing.assert_array_equal(got, want)
    # Every ray of the capture looks down -z: NDC's precondition.
    _, rd = get_rays(8, 8, 10.0, torch.from_numpy(synthetic.forward_facing_poses(20)[5]))
    assert bool((rd[:, 2] < 0).all())


def test_pack_and_unpack_aux_exact():
    rng = np.random.RandomState(1)
    depth = rng.uniform(0.0, 5.0, (50, 1)).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (50, 1)).astype(np.float32)
    acc[:3] = 0.0  # empty rays: the 1e-6 clamp
    for near, far in ((2.0, 6.0), (0.0, 1.0)):
        got = render.pack_aux(torch.from_numpy(depth), torch.from_numpy(acc), near, far).numpy()
        want = np.asarray(jrender.pack_aux(jnp.asarray(depth), jnp.asarray(acc), near, far))
        np.testing.assert_array_equal(got, want)
        img = got.reshape(5, 10, 3)
        d, a = render.unpack_aux(torch.from_numpy(img), near, far)
        wd, wa = jrender.unpack_aux(jnp.asarray(img), near, far)
        np.testing.assert_array_equal(d.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(a.numpy(), np.asarray(wa))


def _assert_aux_close(got, want, atol):
    """The acc channel everywhere; the depth channel where acc >= 0.1, the
    rays the consumers show (a near-empty ray's depth / acc amplifies
    rounding by 1 / acc)."""
    np.testing.assert_allclose(got[..., 1], want[..., 1], atol=atol)
    mask = want[..., 1] >= 0.1
    assert mask.mean() > 0.3
    np.testing.assert_allclose(got[..., 0][mask], want[..., 0][mask], atol=atol)


@pytest.mark.parametrize("ndc,aux", [(True, False), (False, True), (True, True)])
def test_tinynerf_images_match_jax(ndc, aux):
    """NDC colour, world aux and NDC aux images of render_image_fn; NDC
    samples t in [0, 1]. The colour at the render-parity tolerance 2e-5
    (tests/test_torch_port_render.py)."""
    params, jcfg, model, tcfg = tiny_pair(3)
    pose = ff_pose(2) if ndc else synthetic.hemisphere_poses(4)[1]
    near, far = (0.0, 1.0) if ndc else (2.0, 6.0)
    kw = dict(chunk=64, n_samples=24, near=near, far=far, num_freqs=4, ndc=ndc, aux=aux, **IMG)
    got = render.render_image_fn(model, torch.from_numpy(pose), model_cfg=tcfg, **kw).numpy()
    want = np.asarray(jrender.render_image_fn(params, jnp.asarray(pose), model_cfg=jcfg, **kw))
    assert got.shape == (12, 12, 3)
    if aux:
        _assert_aux_close(got, want, 2e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-5)
        # The fused route's plain version on the CPU gives the same image.
        fused = render.render_image_fn(model, torch.from_numpy(pose), model_cfg=tcfg,
                                       use_fused=True, **kw).numpy()
        np.testing.assert_allclose(fused, want, atol=2e-5)


@pytest.mark.parametrize("ndc,aux", [(True, False), (False, True), (True, True)])
def test_hierarchical_images_match_jax(ndc, aux):
    """make_hierarchical_image_renderer: NDC colour (eager and the fused
    route's plain versions) and the fine pass's aux channels, f32, at the
    hierarchical render's tolerance 1e-4 (resampled depths,
    tests/test_torch_port_nerf.py)."""
    params, jcfg, model, tcfg = nerf_pair(4)
    pose = ff_pose(3) if ndc else synthetic.hemisphere_poses(4)[2]
    near, far = (0.0, 1.0) if ndc else (2.0, 6.0)
    kw = dict(chunk=64, n_coarse=16, n_fine=8, near=near, far=far, ndc=ndc, aux=aux, **IMG)
    want = np.asarray(jrender.make_hierarchical_image_renderer(nerf_cfg=jcfg, **kw)(
        params, jnp.asarray(pose)))
    for fused in (False, True):
        got = render.make_hierarchical_image_renderer(nerf_cfg=tcfg, use_fused=fused, **kw)(
            model, torch.from_numpy(pose)).numpy()
        if aux:
            _assert_aux_close(got, want, 1e-4)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4)


def test_config_ndc_swaps_near_far_like_jax():
    for ndc in (False, True):
        j = JConfig(ndc=ndc, near=1.5, far=7.0).train_settings()
        t = Config(ndc=ndc, near=1.5, far=7.0).train_settings()
        assert (t.near, t.far) == (j.near, j.far)
    assert Config().ndc is False


@pytest.fixture(scope="module")
def ff_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=6, h=12, w=12, forward_facing=True)
    path = str(tmp_path_factory.mktemp("data") / "ff.npz")
    np.savez(path, **d)
    return path, d


def test_forward_facing_dataset_like_jax(ff_npz):
    """The port's forward-facing scene: the JAX package's poses bit for
    bit, and images within the port's ground-truth tolerance of its."""
    _, d = ff_npz
    want = jsynthetic.generate_synthetic_dataset(n_poses=6, h=12, w=12, forward_facing=True)
    np.testing.assert_array_equal(d["poses"], want["poses"])
    assert float(d["focal"]) == float(want["focal"])
    np.testing.assert_allclose(d["images"], want["images"], atol=1e-4)


JAX_BASE = dict(iters=3, n_rand=32, n_samples=8, n_fine=8, num_freqs=4, num_freqs_dir=2,
                hidden=32, nerf_depth=3, nerf_skip_at=2, rgb_hidden=16, chunk=64, resume=False,
                log_every=3, preview_every=1000, ckpt_every=1000, bf16=False)


@pytest.fixture(scope="module")
def jax_ndc_ckpts(ff_npz, tmp_path_factory):
    """NDC checkpoints written by a few steps of the JAX trainer: a
    TinyNeRF (depth 3, skip 1) and a NeRF (coarse proposal)."""
    path, _ = ff_npz
    out = tmp_path_factory.mktemp("jax_ndc")
    ckpts = {}
    for model in ("tinynerf", "nerf"):
        ck = str(out / f"{model}.npz")
        jtrain.main(JConfig(model=model, ndc=True, data_path=path, ckpt_path=ck,
                            out_dir=str(out / model), depth=3, skip_at=1, **JAX_BASE))
        ckpts[model] = ck
    return ckpts


@pytest.mark.parametrize("model", ["tinynerf", "nerf"])
@pytest.mark.parametrize("aux", [False, True])
def test_model_io_renders_jax_ndc_checkpoint_like_jax(ff_npz, jax_ndc_ckpts, model, aux):
    """A JAX-written NDC checkpoint: the port reads meta ndc and its
    loader's renderer (reprojected rays over t in [0, 1], colour or aux,
    bf16 as the loaders default) matches the JAX loader's under the bf16
    render gates; the loaded weights in f32 renderers on both sides match
    at the f32 tolerances (2e-5 TinyNeRF, 1e-4 hierarchical)."""
    import dataclasses

    from tinynerf_tpu.utils.model_io import load_model_and_renderer as jload

    path = jax_ndc_ckpts[model]
    _, d = ff_npz
    focal = float(d["focal"])
    kw = dict(H=12, W=12, focal=focal, n_samples=16, chunk=64, aux=aux)
    params, jren, jmeta = jload(path, **kw)
    tmodel, tren, tmeta = load_model_and_renderer(path, fused=False, device="cpu", **kw)
    assert jmeta["cfg"]["ndc"] is True and tmeta["cfg"]["ndc"] is True and tmeta["step"] == 3
    pose = d["poses"][4]
    want = np.asarray(jren(params, jnp.asarray(pose)))
    got = tren(tmodel, torch.from_numpy(pose)).numpy()
    channels = [1] if aux else [0, 1, 2]  # aux: the depth channel of empty rays is undefined
    err = np.abs(got[..., channels] - want[..., channels]).max(axis=-1)
    assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3
    img = dict(H=12, W=12, focal=focal, chunk=64, near=0.0, far=1.0, ndc=True, aux=aux)
    if model == "nerf":
        jcfg = dataclasses.replace(jnerf.NeRFConfig(**NERF), compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tmodel.cfg, compute_dtype=torch.float32)
        jren = jrender.make_hierarchical_image_renderer(n_coarse=16, n_fine=8, nerf_cfg=jcfg, **img)
        tren = render.make_hierarchical_image_renderer(n_coarse=16, n_fine=8, nerf_cfg=tcfg, **img)
        tol = 1e-4
    else:
        jcfg = JTinyConfig(in_dim=27, compute_dtype=jnp.float32, **TINY)
        tcfg = TinyNeRFConfig(in_dim=27, compute_dtype=torch.float32, **TINY)
        jren = jrender.make_image_renderer(n_samples=16, num_freqs=4, model_cfg=jcfg, **img)
        tren = render.make_image_renderer(n_samples=16, num_freqs=4, model_cfg=tcfg, **img)
        tol = 2e-5
    want = np.asarray(jren(params, jnp.asarray(pose)))
    got = tren(tmodel, torch.from_numpy(pose)).numpy()
    if aux:
        np.testing.assert_allclose(got[..., 1], want[..., 1], atol=tol)
        mask = want[..., 1] >= 0.1
        np.testing.assert_allclose(got[..., 0][mask], want[..., 0][mask], atol=tol)
    else:
        np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("model", ["tinynerf", "nerf"])
def test_train_ndc_trains_finite_and_writes_meta(ff_npz, tmp_path, model):
    """train --ndc on the forward-facing scene (the fused route's plain
    versions on the CPU): finite losses, the NDC meta, held-out eval over
    t in [0, 1]; then eval --save-depth writes depth and acc maps whose
    depth is not constant, and make_gif --depth writes frames."""
    path, _ = ff_npz
    ck = str(tmp_path / "ndc.npz")
    metrics = str(tmp_path / "m.jsonl")
    res = train.main(Config(model=model, ndc=True, data_path=path, ckpt_path=ck,
                            out_dir=str(tmp_path / "o"), device="cpu", metrics_path=metrics,
                            holdout=2, depth=3, skip_at=1, iters=4, n_rand=32, n_samples=8,
                            n_fine=8, num_freqs=4, num_freqs_dir=2, hidden=32, nerf_depth=3,
                            nerf_skip_at=2, rgb_hidden=16, chunk=64, resume=False, log_every=2,
                            preview_every=1000, ckpt_every=1000))
    losses = [r["loss"] for r in map(json.loads, open(metrics)) if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert np.isfinite(res["eval"]["psnr_mean"])
    from tinynerf_tpu_torch.utils import checkpoint

    meta = checkpoint.read_meta(ck)["meta"]
    assert meta["cfg"]["ndc"] is True and meta["model"] == model
    out = tmp_path / "eval"
    eval_mod.main(eval_mod.EvalConfig(ckpt_path=ck, data_path=path, out_dir=str(out), views=2,
                                      n_samples=16, save_depth=True, device="cpu"))
    from PIL import Image

    depth = np.asarray(Image.open(out / "depth_000.png"), dtype=np.float32)
    acc = np.asarray(Image.open(out / "acc_000.png"), dtype=np.float32)
    assert depth.shape == acc.shape == (12, 12, 3)
    assert depth.std() > 0 and acc.std() > 0
    frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=ck, data_path=path, n_samples=16,
                                            out_path=str(tmp_path / "d.gif"), n_frames=2,
                                            depth=True, device="cpu"))
    assert frames.shape == (2, 12, 12, 3) and frames.dtype == np.uint8
    assert (tmp_path / "d.gif").exists()


def test_eval_save_depth_unpacks_the_ndc_range(ff_npz, jax_ndc_ckpts, tmp_path, monkeypatch):
    """eval --save-depth on a JAX NDC checkpoint unpacks depths over [0,
    1]: the depth map is the disparity tone map of the aux render over
    that range, pixel for pixel."""
    path, d = ff_npz
    seen = []
    orig = eval_mod.unpack_aux
    monkeypatch.setattr(eval_mod, "unpack_aux",
                        lambda img, near, far: seen.append((near, far)) or orig(img, near, far))
    eval_mod.main(eval_mod.EvalConfig(ckpt_path=jax_ndc_ckpts["nerf"], data_path=path,
                                      out_dir=str(tmp_path), views=1, n_samples=16,
                                      save_depth=True, fused=False, device="cpu"))
    assert seen and set(seen) == {(0.0, 1.0)}
    model, aux_ren, _ = load_model_and_renderer(jax_ndc_ckpts["nerf"], H=12, W=12,
                                                focal=float(d["focal"]), n_samples=16,
                                                fused=False, aux=True, device="cpu")
    img = aux_ren(model, torch.from_numpy(d["poses"][0])).numpy()
    dep, acc = render.unpack_aux(img, 0.0, 1.0)
    shade = (1.0 - np.clip(dep, 0.0, 1.0)) * (acc >= 0.1)
    from PIL import Image

    got = np.asarray(Image.open(tmp_path / "depth_000.png"), dtype=np.float32)[..., 0] / 255.0
    np.testing.assert_allclose(got, shade, atol=1.0 / 255 + 1e-6)


def test_train_ndc_sample_parallel_on_two_ranks(ff_npz, tmp_path):
    """`--ndc --data-parallel --sample-parallel 2 --fused-train` on two gloo
    ranks (K7's plain versions on the CPU): the rays reprojected before the
    sharding, both ranks exit 0 with bit-identical parameters, and the
    checkpoint's meta says ndc."""
    import os
    import subprocess
    import sys

    from tinynerf_tpu_torch.utils import checkpoint

    path, _ = ff_npz
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "tinynerf_tpu_torch.train", "--model", "nerf", "--device", "cpu", "--ndc",
           "--data-parallel", "--sample-parallel", "2", "--fused-train", "--iters", "2",
           "--n-rand", "32", "--n-samples", "8", "--n-fine", "8", "--hidden", "32",
           "--nerf-depth", "3", "--nerf-skip-at", "2", "--num-freqs", "4", "--num-freqs-dir", "2",
           "--rgb-hidden", "16", "--log-every", "2", "--holdout", "1", "--chunk", "64",
           "--no-resume", "--data-path", path, "--ckpt-path", str(tmp_path / "ckpt.npz"),
           "--out-dir", str(tmp_path / "out")]
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "[ndc] rays reprojected" in out and "(K7) on the sample mesh" in out
    digests = {line.split("parameter digest ")[1].split(",")[0] for line in out.splitlines()
               if "parameter digest" in line}
    assert out.count("parameter digest") == 2 and len(digests) == 1, out
    assert checkpoint.read_meta(str(tmp_path / "ckpt.npz"))["meta"]["cfg"]["ndc"] is True
