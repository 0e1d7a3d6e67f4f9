"""Port parity: tinynerf_tpu_torch/ops against tinynerf_tpu/ops on the
same numpy inputs, float32.

Tolerance 1e-5 throughout: the two packages differ by ulps in linspace
(XLA multiplies by 1/(n-1), torch does not) and in libm sin/cos.
"""

import contextlib
import importlib

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



def _padded_on_the_host(rays_o, rays_d, pad):
    """The padding as the wrappers built it before it was made on the
    device: a unit-z row copied from the host, then concatenated."""
    lead = rays_o.shape[:-2]
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=rays_d.device)
    return (torch.cat([rays_o, rays_o.new_zeros(*lead, pad, 3)], dim=-2).contiguous(),
            torch.cat([rays_d, unit_z.expand(*lead, pad, 3)], dim=-2).contiguous())


@contextlib.contextmanager
def no_host_values():
    """Inside: torch.tensor, and torch.as_tensor of anything but a tensor,
    raise. A value built on the host is copied to the device, and a copy
    from pageable memory waits for the device."""
    def refuse(*args, **kwargs):
        raise AssertionError("a value built on the host")

    as_tensor = torch.as_tensor

    def as_tensor_of_tensors(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            refuse()
        return as_tensor(data, *args, **kwargs)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch, "tensor", refuse)
        m.setattr(torch, "as_tensor", as_tensor_of_tensors)
        yield


@pytest.mark.parametrize("site", ["ops.rays", "kernels.fused_nerf", "kernels.fused_render",
                                  "render", "parallel.render"])
@pytest.mark.parametrize("lead", [(), (3,)])  # one scene; stacked scenes (K, R, 3)
@pytest.mark.parametrize("pad", [0, 5])
def test_rays_are_padded_on_the_device(site, lead, pad):
    """K1's wrapper (kernels.fused_render), K3-K7's (through
    kernels.fused_nerf), chunked_over_rays and the sharded renderer pad
    through ops.rays.pad_rays: the host-built construction's tensors bit
    for bit, no value built on the host, and with pad == 0 the rays
    themselves."""
    pad_rays = importlib.import_module(f"tinynerf_tpu_torch.{site}").pad_rays
    assert pad_rays is rays.pad_rays
    g = torch.Generator().manual_seed(pad)
    ro, rd = (torch.randn(*lead, 12, 3, generator=g) for _ in range(2))
    with no_host_values():
        o, d = pad_rays(ro, rd, pad)
    want = _padded_on_the_host(ro, rd, pad)
    assert o.shape == d.shape == (*lead, 12 + pad, 3)
    assert o.is_contiguous() and d.is_contiguous()
    assert torch.equal(o, want[0]) and torch.equal(d, want[1])
    if pad == 0:
        assert o.data_ptr() == ro.data_ptr() and d.data_ptr() == rd.data_ptr()


@pytest.mark.parametrize("site", ["ops.rays", "kernels.fused_nerf", "kernels.fused_nerf_stream",
                                  "kernels.fused_nerf_train", "kernels.fused_partials",
                                  "kernels.fused_train"])
@pytest.mark.parametrize("fill", [0.0, 1.0])
@pytest.mark.parametrize("pad", [0, 5])
def test_rows_are_padded_on_the_device(site, fill, pad):
    """The wrappers' depths, deltas, noise, targets and cotangents (and K2's
    rays) pad through ops.rays.pad_rows: the concatenation's tensors bit
    for bit, no value built on the host, and with pad == 0 no copy."""
    pad_rows = importlib.import_module(f"tinynerf_tpu_torch.{site}").pad_rows
    assert pad_rows is rays.pad_rows
    for shape in ((12, 7), (3, 12, 7)):  # one scene; stacked scenes
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(pad))
        with no_host_values():
            got = pad_rows(x, pad, fill)
        want = torch.cat([x, torch.full((*shape[:-2], pad, 7), fill)], dim=-2)
        assert got.is_contiguous() and torch.equal(got, want)
        assert (got.data_ptr() == x.data_ptr()) == (pad == 0)


@pytest.mark.parametrize("H,W", [(20, 20), (16, 24)])  # 112 padding rays; none
def test_chunked_over_rays_pads_on_the_device(H, W):
    """A view's chunks are the host-built padding's rays bit for bit, and
    the view builds no value on the host."""
    from tinynerf_tpu_torch import render

    hw, chunk = H * W, 128
    pose = torch.from_numpy(_pose(3))
    chunks = []

    def ray_fn(ro, rd):
        chunks.append((ro, rd))
        return torch.zeros(ro.shape[0], 3)

    with no_host_values():
        img = render.chunked_over_rays(ray_fn, H, W, 20.0, pose, chunk)
    assert img.shape == (H, W, 3)
    n_chunks = -(-hw // chunk)
    want = _padded_on_the_host(*rays.get_rays(H, W, 20.0, pose), n_chunks * chunk - hw)
    assert len(chunks) == n_chunks
    assert torch.equal(torch.cat([c[0] for c in chunks]), want[0])
    assert torch.equal(torch.cat([c[1] for c in chunks]), want[1])


@pytest.mark.parametrize("value", ["seed", "seeds", "default_aabb", "linspace"])
def test_the_wrappers_other_values_are_made_on_the_device(value):
    """K2/K4's int seeds, the occupancy box and its segment edges: the
    host-built values bit for bit, with no value built on the host."""
    from tinynerf_tpu_torch.kernels import fused_train
    from tinynerf_tpu_torch.ops import occupancy

    cpu = torch.device("cpu")
    make, want = {
        "seed": (lambda: fused_train._seed_tensor(2**31 - 5, cpu),
                 lambda: torch.tensor([2**31 - 5], dtype=torch.int32)),
        "seeds": (lambda: fused_train._seeds_tensor([7, -3, 2**31 - 1], 3, cpu),
                  lambda: torch.tensor([7, -3, 2**31 - 1], dtype=torch.int32)),
        "default_aabb": (lambda: occupancy.default_aabb(1.3),
                         lambda: torch.tensor([[-1.3] * 3, [1.3] * 3], dtype=torch.float32)),
        "linspace": (lambda: occupancy.linspace(2.0, 6.1, 9),
                     lambda: torch.cat([
                         torch.tensor(2.0) * (1 - torch.arange(8, dtype=torch.float32) / 8)
                         + torch.tensor(6.1) * (torch.arange(8, dtype=torch.float32) / 8),
                         torch.tensor([6.1])])),
    }[value]
    with no_host_values():
        got = make()
    ref = want()
    assert got.dtype == ref.dtype and torch.equal(got, ref)
