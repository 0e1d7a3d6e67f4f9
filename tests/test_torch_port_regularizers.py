"""The sparsity prior (ops/regularizers.py) and the scene box
(ops/occupancy.py) of the port against the JAX package on the CPU:
the box helpers on seeded rays, and the prior's gradients on the same
points and the same parameters in float32, for the TinyNeRF and for the
full NeRF (the mean over its coarse and fine MLPs). No Pallas, no
kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import init_tinynerf
from tinynerf_tpu.ops import occupancy as jocc
from tinynerf_tpu.ops import regularizers as jreg
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_from_jax, nerf_state_to_jax
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax, state_to_jax
from tinynerf_tpu_torch.ops import occupancy
from tinynerf_tpu_torch.ops.regularizers import add_grads, make_sparsity_grad_fn
from tinynerf_tpu_torch.training import TrainSettings

L = 4
TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def test_default_aabb_matches_jax():
    for h in (3.0, 1.0):
        np.testing.assert_array_equal(occupancy.default_aabb(h).numpy(),
                                      np.asarray(jocc.default_aabb(h)))


def test_aabb_from_rays_matches_jax():
    rng = np.random.RandomState(3)
    ro = (rng.randn(4, 50, 3) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.randn(4, 50, 3).astype(np.float32)
    got = occupancy.aabb_from_rays(torch.from_numpy(ro), torch.from_numpy(rd), 2.0, 6.0)
    want = np.asarray(jocc.aabb_from_rays(jnp.asarray(ro), jnp.asarray(rd), 2.0, 6.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _jax_points(key, aabb, n):
    """The points the JAX grads_fn draws from `key` (its own arithmetic)."""
    lo, hi = aabb[0], aabb[1]
    return lo + (hi - lo) * jax.random.uniform(jax.random.fold_in(key, 0x5FA1), (n, 3),
                                               jnp.float32)


def _check(got, want_tree, to_jax, names):
    got_tree = to_jax({n: (g if g is not None else torch.zeros(1)) for n, g in zip(names, got)})
    for a, b in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
        b = np.asarray(b)
        a = np.broadcast_to(np.asarray(a), b.shape)  # a None gradient is zero
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(float(np.abs(b).max()), 1e-30))


def test_sparsity_grads_match_jax_tinynerf():
    jcfg = JaxConfig(in_dim=27, hidden=32, depth=4, skip_at=2, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, init_tinynerf(jax.random.PRNGKey(2), jcfg))
    js = JaxSettings(num_freqs=L, model_cfg=jcfg)
    aabb = jocc.aabb_from_rays(jnp.zeros((1, 3)), jnp.ones((1, 3)), 2.0, 6.0) + jnp.asarray(
        [[-1.0], [1.0]])
    key = jax.random.PRNGKey(9)
    want = jreg.make_sparsity_grad_fn(js, "tinynerf", lam=1e-2, n_points=256, aabb=aabb)(
        jax.tree_util.tree_map(jnp.asarray, params), key)
    model = TinyNeRF(TinyNeRFConfig(in_dim=27, hidden=32, depth=4, skip_at=2,
                                    compute_dtype=torch.float32))
    model.load_state_dict(params_from_jax(params))
    s = TrainSettings(num_freqs=L, model_cfg=model.cfg)
    fn = make_sparsity_grad_fn(s, "tinynerf", lam=1e-2, n_points=256,
                               aabb=torch.from_numpy(np.array(aabb)))
    pts = torch.from_numpy(np.asarray(_jax_points(key, aabb, 256)))
    got = fn.at_points(model, pts)
    _check(got, want, state_to_jax, [n for n, _ in model.named_parameters()])


def test_sparsity_grads_match_jax_nerf():
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jnerf.init_nerf(jax.random.PRNGKey(4), jcfg))
    key = jax.random.PRNGKey(11)
    aabb = jocc.default_aabb()
    want = jreg.make_sparsity_grad_fn(None, "nerf", nerf_cfg=jcfg, lam=1e-3, n_points=200)(
        jax.tree_util.tree_map(jnp.asarray, params), key)
    cfg = NeRFConfig(compute_dtype=torch.float32, **TINY)
    model = NeRF(cfg)
    model.load_state_dict(nerf_params_from_jax(params))
    fn = make_sparsity_grad_fn(None, "nerf", nerf_cfg=cfg, lam=1e-3, n_points=200)
    got = fn.at_points(model, torch.from_numpy(np.asarray(_jax_points(key, aabb, 200))))
    _check(got, want, nerf_state_to_jax, [n for n, _ in model.named_parameters()])


def test_sparsity_grad_fn_draws_in_the_box_and_adds_into_grads():
    """Points from the generator inside the box, the same for the same
    seed; add_grads adds to an existing .grad (a fused kernel's) and sets
    a missing one, and skips the parameters the density does not reach."""
    cfg = NeRFConfig(compute_dtype=torch.float32, **TINY)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0))
    box = torch.tensor([[-1.0, -2.0, 0.5], [1.0, 0.0, 2.5]])
    fn = make_sparsity_grad_fn(None, "nerf", nerf_cfg=cfg, lam=1e-3, n_points=64, aabb=box)
    a = fn(model, torch.Generator().manual_seed(5))
    b = fn(model, torch.Generator().manual_seed(5))
    assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
    u = torch.rand((64, 3), generator=torch.Generator().manual_seed(5))
    pts = box[0] + (box[1] - box[0]) * u
    assert bool(((pts >= box[0]) & (pts <= box[1])).all())
    assert all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, fn.at_points(model, pts)))
    names = [n for n, _ in model.named_parameters()]
    assert all((g is None) == n.split(".")[1].startswith("rgb") for n, g in zip(names, a))
    params = list(model.parameters())
    params[0].grad = torch.ones_like(params[0])
    add_grads(model, a)
    assert torch.equal(params[0].grad, 1.0 + a[0])
    assert torch.equal(params[1].grad, a[1])
    assert all(p.grad is None for p, g in zip(params, a) if g is None)
    # The grid family (item 12) is ported (tests/test_torch_port_grid.py):
    # it needs its GridNeRFConfig.
    with pytest.raises(ValueError, match="requires the GridNeRFConfig"):
        make_sparsity_grad_fn(None, "grid", lam=1e-3)
