"""Checkpoints cross the packages: a JAX save_checkpoint renders the same
image in the port, and a port-written params-only checkpoint is accepted
by the JAX package's restore_params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.models.tinynerf import init_tinynerf
from tinynerf_tpu.render import render_image_fn as jax_render_image_fn
from tinynerf_tpu.training import TrainSettings, init_train_state
from tinynerf_tpu.utils import checkpoint as jax_ckpt
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_to_jax
from tinynerf_tpu_torch.render import render_image_fn
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils.model_io import load_model_and_renderer

META = {"model": "tinynerf", "cfg": {"hidden": 128, "depth": 4, "skip_at": 2, "num_freqs": 10}}
KW = dict(H=12, W=12, focal=15.0, chunk=64, n_samples=16)


def _pose():
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    return pose


def test_param_struct_matches_jax_treedef():
    for depth in (2, 4):
        params = init_tinynerf(jax.random.PRNGKey(0), JaxConfig(depth=depth))
        assert checkpoint.param_struct(depth) == str(jax.tree_util.tree_structure(params))


def test_jax_checkpoint_renders_the_same_in_port(tmp_path):
    jcfg = JaxConfig(compute_dtype=jnp.float32)
    params, opt_state = init_train_state(jax.random.PRNGKey(5), TrainSettings(model_cfg=jcfg))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, params, opt_state, 123, meta=META)

    model = TinyNeRF(TinyNeRFConfig(compute_dtype=torch.float32),
                     generator=torch.Generator().manual_seed(0))
    step, meta = checkpoint.restore_params(path, model)
    assert step == 123 and meta == META
    got = render_image_fn(model, torch.from_numpy(_pose()), **KW)
    want = jax_render_image_fn(params, jnp.asarray(_pose()), model_cfg=jcfg, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_port_checkpoint_restores_in_jax(tmp_path):
    model = TinyNeRF(generator=torch.Generator().manual_seed(6))
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, model, 77, META)
    template = init_tinynerf(jax.random.PRNGKey(0), JaxConfig())
    params, step, meta = jax_ckpt.restore_params(path, template)
    assert step == 77 and meta == META
    want = params_to_jax(model)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_restore_rejects_a_different_model(tmp_path):
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(path, TinyNeRF(generator=torch.Generator().manual_seed(0)), 0, META)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.restore_params(path, TinyNeRF(TinyNeRFConfig(depth=3)))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_params(path, TinyNeRF(TinyNeRFConfig(hidden=64)))


@pytest.mark.parametrize("meta,item", [
    ({"model": "nerf", "cfg": {**META["cfg"], "proposal": "occupancy"}}, "item 11"),
    ({"model": "grid", "cfg": META["cfg"]}, "item 12"),
    ({"model": "tinynerf", "cfg": {**META["cfg"], "ndc": True}}, "item 10"),
])
def test_model_io_names_the_roadmap_item_for_unported_models(tmp_path, meta, item):
    """Items 10 (NDC), 11 (the occupancy proposal) and 12 (the grid family)
    are ported: such checkpoints load, an occupancy one as the single fine
    MLP, a grid one as the GridNeRF of its meta's grid entry (here none:
    the JAX package's defaults); an unknown model is refused by name."""
    from tinynerf_tpu_torch.models.grid_nerf import GridNeRF
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig

    path = str(tmp_path / "other.npz")
    model = TinyNeRF(generator=torch.Generator().manual_seed(0))
    if item == "item 11":
        c = meta["cfg"]
        model = NeRF(NeRFConfig(num_freqs=c["num_freqs"], hidden=c["hidden"], depth=c["depth"],
                                skip_at=c["skip_at"]), parts=("fine",),
                     generator=torch.Generator().manual_seed(0))
    if item == "item 12":
        model = GridNeRF(generator=torch.Generator().manual_seed(0))
    checkpoint.save_params(path, model, 0, meta)
    loaded, renderer, got = load_model_and_renderer(path, H=8, W=8, focal=10.0, device="cpu")
    assert got["cfg"] == meta["cfg"] and type(loaded) is type(model)
    for a, b in zip(loaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    if item == "item 12":
        checkpoint.save_params(path, model, 0, {**meta, "model": "mlp"})
        with pytest.raises(ValueError, match="unknown model 'mlp'"):
            load_model_and_renderer(path, H=8, W=8, focal=10.0, device="cpu")
    if item == "item 10":
        img = renderer(loaded, torch.eye(4))
        assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


def test_model_io_rebuilds_from_meta(tmp_path):
    meta = {"model": "tinynerf", "cfg": {"hidden": 32, "depth": 3, "skip_at": 1, "num_freqs": 4}}
    cfg = TinyNeRFConfig(in_dim=27, hidden=32, depth=3, skip_at=1)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(8))
    path = str(tmp_path / "small.npz")
    checkpoint.save_params(path, model, 9, meta)
    loaded, renderer, got_meta = load_model_and_renderer(
        path, H=8, W=8, focal=10.0, n_samples=8, device="cpu")
    assert got_meta["step"] == 9 and loaded.cfg == cfg
    for a, b in zip(loaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    img = renderer(loaded, torch.from_numpy(_pose()))
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
