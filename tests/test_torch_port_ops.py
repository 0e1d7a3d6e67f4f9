"""Port parity: tinynerf_tpu_torch/ops against tinynerf_tpu/ops on the
same numpy inputs, float32.

Tolerance 1e-5 throughout: the two packages differ by ulps in linspace
(XLA multiplies by 1/(n-1), torch does not) and in libm sin/cos.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.ops import camera as jcam
from tinynerf_tpu.ops import encoding as jenc
from tinynerf_tpu.ops import rays as jrays
from tinynerf_tpu.ops import sampling as jsamp
from tinynerf_tpu.ops import volume as jvol
from tinynerf_tpu_torch.ops import camera, encoding, rays, sampling, volume

ATOL = 1e-5


def _pose(seed):
    """A random rigid camera-to-world matrix."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.randn(3) * 2.0
    return c2w


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.3).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("hw_focal", [(8, 12, 10.0), (16, 16, 20.0)])
def test_get_rays_matches_jax(hw_focal):
    H, W, focal = hw_focal
    c2w = _pose(H)
    want_o, want_d = jrays.get_rays(H, W, focal, jnp.asarray(c2w))
    got_o, got_d = rays.get_rays(H, W, focal, torch.from_numpy(c2w))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL)


def test_get_rays_for_poses_matches_jax():
    c2ws = np.stack([_pose(s) for s in range(3)])
    want_o, want_d = jrays.get_rays_for_poses(6, 5, 7.0, jnp.asarray(c2ws))
    got_o, got_d = rays.get_rays_for_poses(6, 5, 7.0, torch.from_numpy(c2ws))
    assert got_o.shape == (3, 30, 3)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL)


def test_spiral_poses_matches_jax():
    c2w = _pose(5)
    want = jcam.spiral_poses(jnp.asarray(c2w), n_frames=7, radius=0.3)
    got = camera.spiral_poses(torch.from_numpy(c2w), n_frames=7, radius=0.3)
    assert got.shape == (7, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("num_freqs", [4, 10])
def test_positional_encoding_matches_jax(num_freqs):
    x = np.random.RandomState(num_freqs).uniform(-2, 2, (50, 3)).astype(np.float32)
    want = jenc.positional_encoding(jnp.asarray(x), num_freqs=num_freqs)
    got = encoding.positional_encoding(torch.from_numpy(x), num_freqs=num_freqs)
    assert got.shape == (50, encoding.encoding_dim(num_freqs)) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_stratified_samples_deterministic_matches_jax():
    ro, rd = _rays(32, 1)
    wz, wp = jsamp.stratified_samples(2.0, 6.0, 16, jnp.asarray(ro), jnp.asarray(rd), randomized=False)
    gz, gp = sampling.stratified_samples(2.0, 6.0, 16, torch.from_numpy(ro), torch.from_numpy(rd),
                                         randomized=False)
    np.testing.assert_allclose(gz.numpy(), np.asarray(wz), atol=ATOL)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=ATOL)


def test_stratified_samples_randomized_bins_and_replay():
    """One draw per bin, inside the bin, replayed from the same seed."""
    ro, rd = _rays(64, 2)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    draw = lambda seed: sampling.stratified_samples(
        2.0, 6.0, 16, ro, rd, generator=torch.Generator().manual_seed(seed))[0]
    z = draw(3)
    base, _ = sampling.stratified_samples(2.0, 6.0, 16, ro, rd, randomized=False)
    mids = 0.5 * (base[:, :-1] + base[:, 1:])
    lower = torch.cat([base[:, :1], mids], dim=-1)
    upper = torch.cat([mids, base[:, -1:]], dim=-1)
    assert bool(((z >= lower) & (z <= upper)).all())
    assert bool((z[:, 1:] >= z[:, :-1]).all())
    assert torch.equal(z, draw(3))
    assert not torch.equal(z, draw(4))
    with pytest.raises(ValueError):
        sampling.stratified_samples(2.0, 6.0, 16, ro, rd)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_volume_render_matches_jax(white_bkgd):
    rng = np.random.RandomState(7)
    R, S = 40, 24
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    sigma = np.maximum(rng.randn(R, S, 1) * 3.0, 0).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    _, rd = _rays(R, 8)
    want = jvol.volume_render(*map(jnp.asarray, (rgb, sigma, z, rd)), white_bkgd=white_bkgd)
    got = volume.volume_render(*map(torch.from_numpy, (rgb, sigma, z, rd)), white_bkgd=white_bkgd)
    assert volume.DELTA_INF == jvol.DELTA_INF and volume.TRANS_EPS == jvol.TRANS_EPS
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
