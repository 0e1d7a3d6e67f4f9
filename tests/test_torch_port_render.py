"""Port parity for the slice as a whole: the port's render_image_fn
against the JAX package's and against the golden image, on JAX weights
carried over with params_from_jax. Setup as tests/test_golden_render.py:
PRNGKey(42) params, 16x16, focal 20, chunk 64, 32 samples, f32."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.render import render_image_fn as jax_render_image_fn
from tinynerf_tpu.training import TrainSettings, init_train_state
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig, params_from_jax
from tinynerf_tpu_torch.ops.camera import spiral_poses
from tinynerf_tpu_torch.render import make_image_renderer, render_image_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_render_16x16.npy")
KW = dict(H=16, W=16, focal=20.0, n_samples=32)


@pytest.fixture(scope="module")
def golden_setup():
    jcfg = JaxConfig(compute_dtype=jnp.float32)
    params, _ = init_train_state(jax.random.PRNGKey(42), TrainSettings(model_cfg=jcfg))
    model = TinyNeRF(TinyNeRFConfig(compute_dtype=torch.float32))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 4.0
    return params, jcfg, model, pose


@pytest.mark.parametrize("use_fused", [False, True])
def test_render_matches_golden_and_jax(golden_setup, use_fused):
    """use_fused=True takes the kernel's plain version on the CPU."""
    params, jcfg, model, pose = golden_setup
    got = render_image_fn(model, torch.from_numpy(pose), chunk=64, use_fused=use_fused, **KW)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN), atol=2e-5)
    want = jax_render_image_fn(params, jnp.asarray(pose), chunk=64, model_cfg=jcfg, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_chunk_size_invariance(golden_setup):
    """Chunking must not change pixels (reference guarantee)."""
    _, _, model, pose = golden_setup
    imgs = [render_image_fn(model, torch.from_numpy(pose), chunk=c, **KW) for c in (32, 64, 256)]
    np.testing.assert_allclose(imgs[0].numpy(), imgs[1].numpy(), atol=1e-6)
    np.testing.assert_allclose(imgs[1].numpy(), imgs[2].numpy(), atol=1e-6)


def test_frames_renderer_matches_per_pose(golden_setup):
    _, _, model, pose = golden_setup
    poses = spiral_poses(torch.from_numpy(pose), n_frames=3, radius=0.3)
    batched = make_image_renderer(frames=True, chunk=64, **KW)(model, poses)
    single = make_image_renderer(chunk=64, **KW)
    assert batched.shape == (3, 16, 16, 3)
    for i in range(3):
        assert torch.equal(batched[i], single(model, poses[i]))


def test_render_ignores_global_grad_mode(golden_setup):
    """Renders are inference: no autograd graph whatever the global mode."""
    _, _, model, pose = golden_setup
    with torch.enable_grad():
        img = render_image_fn(model, torch.from_numpy(pose), chunk=64, **KW)
    assert not img.requires_grad
