"""Port parity for the full NeRF: sample_pdf, the NeRF MLP, the eager
hierarchical render, the checkpoint bridge, model_io and the eval and
make_gif drivers, against the JAX package on the CPU.

Tiny config of tests/test_fused_nerf.py:22-25 (L 4, L_dir 2, hidden 32,
depth 3, skip 2, rgb_hidden 16), R <= 64, 16 coarse + 8 fine samples.
Inputs come from numpy with a seed; weights are carried across with
nerf_params_from_jax.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu import config as jconfig
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops import sampling as jsampling
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu.render import make_hierarchical_image_renderer as jax_hier_renderer
from tinynerf_tpu.utils import checkpoint as jckpt
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import make_gif as gif_mod
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.nerf import (
    NeRF,
    NeRFConfig,
    nerf_params_from_jax,
    nerf_params_to_jax,
    render_rays_hierarchical,
)
from tinynerf_tpu_torch.models.tinynerf import count_params
from tinynerf_tpu_torch.ops.sampling import sample_pdf
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
TINY_META_CFG = {**TINY, "n_fine": 8, "proposal": "coarse"}


def cfgs(jdt=jnp.float32, tdt=torch.float32, **kw):
    over = {**TINY, **kw}
    return jnerf.NeRFConfig(compute_dtype=jdt, **over), NeRFConfig(compute_dtype=tdt, **over)


def pair(seed, jdt=jnp.float32, tdt=torch.float32, **kw):
    """JAX params and a port NeRF holding the same weights."""
    jcfg, tcfg = cfgs(jdt, tdt, **kw)
    params = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf(jax.random.PRNGKey(seed), jcfg))
    model = NeRF(tcfg)
    model.load_state_dict(nerf_params_from_jax(params))
    return params, jcfg, model, tcfg


def rays(n, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.1).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    # Non-unit lengths: the deltas scale with ||d||, the view encoding not.
    rd *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _pdf_inputs(seed, n=48, n_bins=14, zero_rows=0):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (n, n_bins + 1)).astype(np.float32), axis=1)
    # Like composite weights: some bins empty. (A u that lands in a bin of
    # pdf ~eps would amplify the f32 rounding of cumsum, which XLA and
    # torch sum in different orders, by 1/pdf; linspace u's do not.)
    weights = (rng.rand(n, n_bins) * (rng.rand(n, n_bins) > 0.2)).astype(np.float32)
    weights[:zero_rows] = 0.0  # an empty ray: the eps floor keeps it finite
    return bins, weights


@pytest.mark.parametrize("n_imp,zero_rows", [(8, 0), (33, 5)])
def test_sample_pdf_deterministic_matches_jax(n_imp, zero_rows):
    """To 1e-5, except where a u falls in an empty bin (pdf ~eps): there
    the sample moves by (cdf rounding) / pdf of the bin width, and XLA
    (sequential f32) and torch (f64 accumulation on the CPU) round the
    cumsum differently at 1e-7. Such samples must stay in their bin."""
    bins, weights = _pdf_inputs(0, zero_rows=zero_rows)
    want = np.asarray(jsampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), n_imp,
                                           randomized=False))
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n_imp,
                     randomized=False).numpy()
    assert got.shape == (48, n_imp)
    pdf = (weights + 1e-5) / (weights + 1e-5).sum(axis=1, keepdims=True)
    rows = np.arange(48)[:, None]
    k = np.clip([np.searchsorted(b, w, side="right") - 1 for b, w in zip(bins, want)], 0, 13)
    empty = pdf[rows, k] < 1e-3
    assert empty.mean() < 0.1  # the u = 0 and u = 1 ends land in empty end bins
    np.testing.assert_allclose(got[~empty], want[~empty], atol=1e-5)
    lo, hi = bins[rows, k], bins[rows, k + 1]
    assert bool(((got >= lo - 1e-5) & (got <= hi + 1e-5))[empty].all())


@pytest.mark.parametrize("stratified", [False, True])
def test_sample_pdf_randomized_in_bins_sorted_and_replayable(stratified):
    bins, weights = _pdf_inputs(1)
    b, w = torch.from_numpy(bins), torch.from_numpy(weights)

    def draw(seed):
        return sample_pdf(b, w, 64, randomized=True, stratified=stratified,
                          generator=torch.Generator().manual_seed(seed))

    z = draw(3)
    assert bool((z >= b[:, :1]).all() and (z <= b[:, -1:]).all())
    assert bool((z[:, 1:] >= z[:, :-1]).all())
    assert torch.equal(z, draw(3)) and not torch.equal(z, draw(4))
    # Samples follow the PDF: the heaviest bin of each ray gets at least
    # its share minus a generous margin, averaged over the rays.
    heavy = weights.argmax(axis=1)
    share = (weights.max(axis=1) + 1e-5) / (weights + 1e-5).sum(axis=1)
    lo, hi = bins[np.arange(48), heavy], bins[np.arange(48), heavy + 1]
    zn = z.numpy()
    frac = ((zn >= lo[:, None]) & (zn <= hi[:, None])).mean(axis=1)
    assert frac.mean() > 0.8 * share.mean()
    with pytest.raises(ValueError, match="generator"):
        sample_pdf(b, w, 4, randomized=True)


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_nerf_mlp_matches_jax_f32(use_viewdirs):
    params, jcfg, model, tcfg = pair(0, use_viewdirs=use_viewdirs)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x_enc = np.array(jenc(jnp.asarray(x), num_freqs=4))
    d_enc = np.array(jenc(jnp.asarray(d), num_freqs=2)) if use_viewdirs else None
    want_rgb, want_sigma = jnerf.apply_nerf_mlp(
        params["coarse"], jnp.asarray(x_enc), None if d_enc is None else jnp.asarray(d_enc), jcfg)
    with torch.no_grad():
        rgb, sigma = model.coarse(torch.from_numpy(x_enc),
                                  None if d_enc is None else torch.from_numpy(d_enc), tcfg)
    assert rgb.shape == (64, 3) and sigma.shape == (64, 1)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=1e-5)


def test_nerf_mlp_matches_jax_bf16():
    """bf16 matmul inputs, f32 accumulation in both: the rounding points
    are the same, so only the f32 summation order differs (1e-3, the
    JAX package's pipeline tolerance)."""
    params, jcfg, model, tcfg = pair(2, jnp.bfloat16, torch.bfloat16)
    rng = np.random.RandomState(3)
    x_enc = np.array(jenc(jnp.asarray(rng.uniform(-1, 1, (64, 3)).astype(np.float32)), num_freqs=4))
    d_enc = np.array(jenc(jnp.asarray(rng.uniform(-1, 1, (64, 3)).astype(np.float32)), num_freqs=2))
    want_rgb, want_sigma = jnerf.apply_nerf_mlp(params["fine"], jnp.asarray(x_enc), jnp.asarray(d_enc), jcfg)
    with torch.no_grad():
        rgb, sigma = model.fine(torch.from_numpy(x_enc), torch.from_numpy(d_enc), tcfg)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-3)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), atol=1e-3)


def test_flagship_param_count_and_tree_round_trip():
    jcfg = jnerf.NeRFConfig(hidden=256)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(0), jcfg)
    model = NeRF(NeRFConfig(hidden=256), generator=torch.Generator().manual_seed(0))
    assert count_params(model.coarse) == 511_684 == jnerf.count_params(jparams["coarse"])
    assert count_params(model) == 1_023_368
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = nerf_params_to_jax(NeRF(NeRFConfig(hidden=256)).requires_grad_(False))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    model.load_state_dict(nerf_params_from_jax(tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(nerf_params_to_jax(model))):
        np.testing.assert_array_equal(a, b)


def test_render_rays_hierarchical_matches_jax():
    """Coarse and fine composites in f32. Both sides run the same ops in
    f32; the resampled depths inherit ulp-level differences, so 1e-4."""
    params, jcfg, model, tcfg = pair(4)
    ro, rd = rays(64, 5)
    want_c, want_f = jnerf.render_rays_hierarchical(
        params, jnp.asarray(ro), jnp.asarray(rd), n_coarse=16, n_fine=8, cfg=jcfg, randomized=False)
    with torch.no_grad():
        got_c, got_f = render_rays_hierarchical(
            model, torch.from_numpy(ro), torch.from_numpy(rd), n_coarse=16, n_fine=8, cfg=tcfg)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-4)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4)


def test_render_rays_hierarchical_training_options_raise():
    """The randomized render needs its generator; the aux channels (ported,
    tests/test_torch_port_ndc_aux.py) add the fine depth and opacity."""
    _, _, model, tcfg = pair(0)
    ro, rd = (torch.from_numpy(a) for a in rays(4, 0))
    with pytest.raises(ValueError, match="requires a generator"):
        render_rays_hierarchical(model, ro, rd, cfg=tcfg, randomized=True)
    with torch.no_grad():
        out = render_rays_hierarchical(model, ro, rd, cfg=tcfg, return_aux=True)
        plain = render_rays_hierarchical(model, ro, rd, cfg=tcfg)
    assert len(out) == 4 and out[2].shape == (4, 1) and out[3].shape == (4, 1)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])


def test_nerf_cfg_matches_jax_config():
    kw = dict(hidden=256, nerf_depth=6, nerf_skip_at=3, num_freqs_dir=3, rgb_hidden=32, bf16=False)
    j, t = jconfig.Config(**kw).nerf_cfg(), Config(**kw).nerf_cfg()
    for f in ("num_freqs", "num_freqs_dir", "hidden", "depth", "skip_at", "rgb_hidden", "use_viewdirs"):
        assert getattr(j, f) == getattr(t, f)
    assert t.compute_dtype == torch.float32
    assert (Config().model, Config().n_fine, Config().proposal) == ("tinynerf", 64, "coarse")


def test_checkpoint_bridge_both_ways(tmp_path):
    params, jcfg, model, tcfg = pair(6)
    # JAX save_checkpoint -> port restore_params (params only).
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, params, {"count": np.zeros((), np.int32)}, 17,
                          meta={"model": "nerf", "cfg": TINY_META_CFG})
    fresh = NeRF(tcfg, generator=torch.Generator().manual_seed(9))
    step, meta = checkpoint.restore_params(jpath, fresh)
    assert step == 17 and meta["model"] == "nerf"
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # The treedef string is JAX's own.
    info = checkpoint.read_meta(jpath)
    assert info["param_struct"] == checkpoint.tree_struct(nerf_params_to_jax(model))
    assert info["n_params"] == 2 * (2 * TINY["depth"] + 6)
    # Port save_params -> JAX restore_params.
    ppath = str(tmp_path / "port.npz")
    checkpoint.save_params(ppath, model, 23, meta={"model": "nerf", "cfg": TINY_META_CFG})
    template = jnerf.init_nerf(jax.random.PRNGKey(1), jcfg)
    got, step, meta = jckpt.restore_params(ppath, template)
    assert step == 23 and meta["cfg"]["hidden"] == 32
    assert checkpoint.read_meta(ppath)["param_struct"] == str(jax.tree_util.tree_structure(template))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # A TinyNeRF model refuses the NeRF checkpoint.
    from tinynerf_tpu_torch.models.tinynerf import TinyNeRF

    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore_params(ppath, TinyNeRF())


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=3, h=8, w=8)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


@pytest.fixture(scope="module")
def jax_nerf_ckpt(tmp_path_factory):
    """A NeRF checkpoint written by the JAX package (bf16 at render time,
    the model_io default)."""
    jcfg, _ = cfgs()
    params = jnerf.init_nerf(jax.random.PRNGKey(7), jcfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "nerf.npz")
    jckpt.save_checkpoint(path, params, {"count": np.zeros((), np.int32)}, 5,
                          meta={"model": "nerf", "cfg": TINY_META_CFG})
    return path, params


def test_model_io_renders_jax_nerf_checkpoint_like_jax(jax_nerf_ckpt):
    path, params = jax_nerf_ckpt
    pose = synthetic.hemisphere_poses(3)[1]
    kw = dict(H=8, W=8, focal=10.0, chunk=32)
    model, renderer, meta = load_model_and_renderer(path, fused=False, device="cpu", **kw)
    assert meta["model"] == "nerf" and meta["step"] == 5
    assert isinstance(model, NeRF) and model.cfg.compute_dtype == torch.bfloat16
    got = renderer(model, torch.from_numpy(pose)).numpy()
    ncfg = jnerf.NeRFConfig(**TINY)  # model_io's bf16 default
    want = np.asarray(jax_hier_renderer(n_coarse=64, n_fine=8, nerf_cfg=ncfg, **kw)(params, jnp.asarray(pose)))
    assert got.shape == (8, 8, 3)
    # bf16 matmul inputs on both sides: the JAX package's render gates.
    err = np.abs(got - want).max(axis=-1)
    assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3
    # The fused route (its plain versions on the CPU) gives the same image.
    _, fused_renderer, _ = load_model_and_renderer(path, fused=True, device="cpu", **kw)
    np.testing.assert_allclose(fused_renderer(model, torch.from_numpy(pose)).numpy(), got, atol=1e-3)


def test_model_io_n_fine_override(jax_nerf_ckpt, monkeypatch):
    """None keeps the checkpoint's n_fine; an explicit 0 means 0."""
    from tinynerf_tpu_torch import render

    seen = []
    orig = render.render_rays_hierarchical

    def spy(*a, **kw):
        seen.append(kw["n_fine"])
        return orig(*a, **kw)

    monkeypatch.setattr(render, "render_rays_hierarchical", spy)
    path, _ = jax_nerf_ckpt
    pose = torch.from_numpy(synthetic.hemisphere_poses(3)[0])
    for n_fine, want in ((None, 8), (0, 0), (24, 24)):
        model, renderer, _ = load_model_and_renderer(
            path, H=4, W=4, focal=5.0, n_samples=16, fused=False, n_fine=n_fine, device="cpu")
        img = renderer(model, pose)
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        assert seen[-1] == want


def test_train_refuses_nerf_model(tmp_path):
    """The NeRF trains (tests/test_torch_port_nerf_train_drivers.py), with
    the occupancy proposal too (tests/test_torch_port_occupancy.py); what
    it refuses is the proposal with --sample-parallel (as the JAX package),
    the proposal for the TinyNeRF and for the grid family (item 12, ported:
    tests/test_torch_port_grid.py), whose fine levels concentrate capacity
    themselves, as the JAX package refuses it."""
    with pytest.raises(ValueError, match="does not compose with --sample-parallel"):
        train.main(Config(model="nerf", proposal="occupancy", data_parallel=True,
                          sample_parallel=2, device="cpu", out_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="requires --model nerf"):
        train.main(Config(proposal="occupancy", device="cpu", out_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="nerf-family sampler"):
        train.main(Config(model="grid", proposal="occupancy", device="cpu",
                          out_dir=str(tmp_path)))


def test_eval_driver_n_fine_and_make_gif(tiny_npz, jax_nerf_ckpt, tmp_path):
    path, _ = jax_nerf_ckpt
    res = {}
    for n_fine in (None, 24):
        out = tmp_path / f"eval_{n_fine}"
        res[n_fine] = eval_mod.main(eval_mod.EvalConfig(
            ckpt_path=path, data_path=tiny_npz, out_dir=str(out), views=2, n_samples=16,
            n_fine=n_fine, device="cpu"))
        assert (out / "metrics.json").exists() and (out / "view_000.png").exists()
        assert np.isfinite(res[n_fine]["psnr_mean"])
    # More fine samples change the image of the same weights.
    assert res[None]["psnr_mean"] != res[24]["psnr_mean"]
    frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=path, data_path=tiny_npz, n_samples=16,
                                            out_path=str(tmp_path / "n.gif"), n_frames=2,
                                            device="cpu"))
    assert frames.shape == (2, 8, 8, 3) and frames.dtype == np.uint8
