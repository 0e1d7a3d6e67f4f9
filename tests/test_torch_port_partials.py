"""Port parity for the blockwise composite and K7 (block partials) on the
CPU.

The block ops of ops/volume.py against tinynerf_tpu/ops/volume.py:93-173,
and K7's wrapper (kernels/fused_partials.py: on CPU tensors the plain
versions, under its torch.autograd.Function) against the JAX package's
XLA composition of apply_nerf_mlp and composite_block_partials, as
tests/test_fused_partials.py:39-160 holds the Pallas pair to it. The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.

The JAX tests' TINY config, f32. Tolerances are the JAX package's own:
the block ops 1e-6, the partials 1e-5, the loss 1e-6 and every gradient
leaf 3e-4 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops import volume as jvol
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu_torch.kernels.fused_partials import (
    fused_block_partials_bwd,
    fused_block_partials_fwd,
    make_fused_block_partials_fn,
)
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_from_jax, nerf_state_to_jax
from tinynerf_tpu_torch.ops import volume as tvol

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
    return params["coarse"], jcfg, model.coarse, tcfg


def case(R=32, S=16, seed=0, noise_std=0.5):
    """tests/test_fused_partials.py:26-36: rays, target, sorted depths, noise."""
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    tgt = rng.rand(R, 3).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)).astype(np.float32), axis=1)
    noise = (rng.randn(R, S) * noise_std).astype(np.float32)
    return ro, rd, tgt, z, noise


def t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def jax_shard(mlp, cfg, ro, rd, z, deltas, noise, sl):
    """composite_block_partials over the XLA MLP on the shard columns sl
    (tests/test_fused_partials.py:39-53)."""
    R = ro.shape[0]
    zb, db, nb = z[:, sl], deltas[:, sl], noise[:, sl]
    sh = zb.shape[1]
    pts = ro[:, None, :] + rd[:, None, :] * zb[..., None]
    x = jenc(pts.reshape(-1, 3), num_freqs=cfg.num_freqs)
    de = None
    if cfg.use_viewdirs:
        vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        de = jnp.repeat(jenc(vd, num_freqs=cfg.num_freqs_dir), sh, axis=0)
    rgb, sig = jnerf.apply_nerf_mlp(mlp, x, de, cfg, sigma_noise=nb.reshape(-1, 1))
    return jvol.composite_block_partials(rgb.reshape(R, sh, 3), sig.reshape(R, sh), zb, db,
                                         return_weights=True)


def assert_tree_close(ref, got, rtol=3e-4):
    """tests/test_fused_partials.py:56-61."""
    flat_r, tr = jax.tree_util.tree_flatten(ref)
    flat_g, tg = jax.tree_util.tree_flatten(got)
    assert str(tr) == str(tg)
    for a, b in zip(flat_r, flat_g):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=rtol * max(1e-6, float(np.abs(a).max())) + 1e-7)


# 1. The block ops.


def _block_case(seed, R=16, S=32):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(R, S, 3).astype(np.float32)
    sigma = (np.abs(rng.randn(R, S)) * 5).astype(np.float32)
    z = np.sort(2 + 4 * rng.rand(R, S).astype(np.float32), axis=-1)
    rd = rng.randn(R, 3).astype(np.float32)
    return rgb, sigma, z, rd


def test_global_deltas_match_jax():
    _, _, z, rd = _block_case(0)
    got = tvol.global_deltas(*t(z, rd))
    np.testing.assert_allclose(got.numpy(), np.asarray(jvol.global_deltas(z, rd)), atol=1e-6)


def test_composite_block_partials_with_weights_match_jax():
    rgb, sigma, z, rd = _block_case(1)
    deltas = np.asarray(jvol.global_deltas(z, rd))
    sl = slice(8, 24)
    want, want_w = jvol.composite_block_partials(rgb[:, sl], sigma[:, sl], z[:, sl], deltas[:, sl],
                                                 return_weights=True)
    got, got_w = tvol.composite_block_partials(*t(rgb[:, sl], sigma[:, sl], z[:, sl],
                                                  deltas[:, sl]), return_weights=True)
    for k in ("T", "C", "D", "A"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-6)


def test_combine_block_partials_matches_jax():
    rng = np.random.RandomState(2)
    stacked = {"T": rng.rand(4, 16).astype(np.float32), "C": rng.rand(4, 16, 3).astype(np.float32),
               "D": (4 * rng.rand(4, 16)).astype(np.float32), "A": rng.rand(4, 16).astype(np.float32)}
    for white in (True, False):
        want = jvol.combine_block_partials(stacked, white_bkgd=white)
        got = tvol.combine_block_partials({k: torch.from_numpy(v) for k, v in stacked.items()},
                                          white_bkgd=white)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("n_blocks", [1, 2, 4])
def test_volume_render_blockwise_matches_jax(n_blocks):
    rgb, sigma, z, rd = _block_case(3)
    want = jvol.volume_render_blockwise(rgb, sigma, z, rd, n_blocks)
    got = tvol.volume_render_blockwise(*t(rgb, sigma, z, rd), n_blocks)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    with pytest.raises(ValueError, match="n_blocks"):
        tvol.volume_render_blockwise(*t(rgb, sigma, z, rd), 5)


# 2. K7's forward.


@pytest.mark.parametrize("n_shards,sb", [(2, 4), (4, 4), (1, 8)])
def test_partials_forward_matches_jax_composite(n_shards, sb):
    jmlp, jcfg, mlp, tcfg = pair(0)
    ro, rd, _, z, noise = case()
    deltas = np.asarray(jvol.global_deltas(z, rd))
    sh = z.shape[1] // n_shards
    fn = make_fused_block_partials_fn(tcfg, emit_weights=True, sample_block=sb)
    launches = (fused_block_partials_fwd.launches, fused_block_partials_bwd.launches)
    for b in range(n_shards):
        sl = slice(b * sh, (b + 1) * sh)
        with torch.no_grad():
            got, got_w = fn(mlp, *t(ro, rd, z[:, sl], deltas[:, sl], noise[:, sl]))
        want, want_w = jax_shard(jmlp, jcfg, ro, rd, z, deltas, noise, sl)
        for k in ("T", "C", "D", "A"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                       err_msg=f"shard {b} partial {k}")
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)
    # CPU tensors take the plain versions: no kernel launched.
    assert (fused_block_partials_fwd.launches, fused_block_partials_bwd.launches) == launches


# 3. K7's autograd.Function through stack -> combine -> MSE.


def _losses(jmlp, jcfg, mlp, tcfg, ro, rd, tgt, z, noise, n_shards, emit_weights):
    """(port loss, port grads as a JAX tree, JAX loss, JAX grads) of
    mse(combine(shards)) (+ 0.1 mean w^2 per shard with emit_weights)."""
    deltas = np.asarray(jvol.global_deltas(z, rd))
    sh = z.shape[1] // n_shards
    slices = [slice(b * sh, (b + 1) * sh) for b in range(n_shards)]

    def jax_loss(p):
        outs = [jax_shard(p, jcfg, ro, rd, z, deltas, noise, sl) for sl in slices]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[o[0] for o in outs])
        comp, _, _ = jvol.combine_block_partials(stacked, white_bkgd=True)
        total = jnp.mean((comp - tgt) ** 2)
        if emit_weights:
            total = total + 0.1 * sum(jnp.mean(o[1] ** 2) for o in outs)
        return total

    fn = make_fused_block_partials_fn(tcfg, emit_weights=emit_weights, sample_block=4)
    outs = [fn(mlp, *t(ro, rd, z[:, sl], deltas[:, sl], noise[:, sl])) for sl in slices]
    stacked = {k: torch.stack([o[0][k] for o in outs]) for k in ("T", "C", "D", "A")}
    comp, _, _ = tvol.combine_block_partials(stacked, white_bkgd=True)
    loss = torch.mean((comp - torch.from_numpy(tgt)) ** 2)
    if emit_weights:
        loss = loss + 0.1 * sum(torch.mean(o[1] ** 2) for o in outs)
    grads = torch.autograd.grad(loss, list(mlp.parameters()))
    tree = nerf_state_to_jax({f"{part}.{n}": g for part in ("coarse", "fine")
                              for (n, _), g in zip(mlp.named_parameters(), grads)})["coarse"]
    lj, gj = jax.value_and_grad(jax_loss)(jmlp)
    return float(loss.detach()), tree, float(lj), gj


@pytest.mark.parametrize("emit_weights", [True, False])
def test_partials_grads_match_jax_grad_through_combine(emit_weights):
    jmlp, jcfg, mlp, tcfg = pair(3)
    ro, rd, tgt, z, noise = case(seed=3)
    lt, gt, lj, gj = _losses(jmlp, jcfg, mlp, tcfg, ro, rd, tgt, z, noise, 2, emit_weights)
    np.testing.assert_allclose(lt, lj, atol=1e-6)
    assert_tree_close(gj, gt)


def test_partials_no_viewdirs():
    jmlp, jcfg, mlp, tcfg = pair(5, use_viewdirs=False)
    ro, rd, tgt, z, noise = case(R=16, S=8, seed=5)
    lt, gt, lj, gj = _losses(jmlp, jcfg, mlp, tcfg, ro, rd, tgt, z, noise, 1, False)
    np.testing.assert_allclose(lt, lj, atol=1e-6)
    assert_tree_close(gj, gt)


def test_partials_gradients_go_to_the_mlp_only():
    """Rays, depths, deltas and noise get no gradient (:554-557)."""
    _, _, mlp, tcfg = pair(6)
    ro, rd, _, z, noise = case(R=8, S=8, seed=6)
    inputs = [x.requires_grad_() for x in t(ro, rd, z, np.asarray(jvol.global_deltas(z, rd)),
                                            noise)]
    partials, _ = make_fused_block_partials_fn(tcfg, sample_block=4)(mlp, *inputs)
    partials["C"].sum().backward()
    assert all(x.grad is None for x in inputs)
    assert all(p.grad is not None for p in mlp.parameters())


def test_partials_sample_block_must_divide_the_shard():
    _, _, mlp, tcfg = pair(0)
    ro, rd, _, z, noise = case(R=24, S=8)
    deltas = np.asarray(jvol.global_deltas(z, rd))
    fn = make_fused_block_partials_fn(tcfg, sample_block=3)
    with pytest.raises(ValueError, match="sample_block"):
        fn(mlp, *t(ro, rd, z, deltas, noise))
    # Any ray count: the CUDA wrapper pads the rays, so R=24 is taken.
    partials, w = make_fused_block_partials_fn(tcfg, sample_block=4)(mlp, *t(ro, rd, z, deltas,
                                                                            noise))
    assert partials["C"].shape == (24, 3) and w is None
