"""The fused render (K1), train (K2), NeRF (K3), streamed NeRF (K5),
NeRF train (K4), streamed NeRF train (K6) and block-partials (K7)
kernels against their plain versions, K2's and K4's jitter, the routes
of K1, K2, K3/K5 and K4/K6/K7 (bf16 at the tensor-core shapes on the
tensor cores, f32 and other shapes on the CUDA cores; a tensor-core width
without its fragments refused), and the scene axis of K2, K4 and K6
(multi-scene training: each scene of a batched launch bit-identical to a
one-scene launch; counts and strides checked in C), and K3-K7 at every
NeRF width and sample count the JAX kernels take (nerf_shape's general
kernel and its spill route, forced at recipe shapes bit-identical to the
one-round kernels), on a CUDA device.

Skips without one. This file imports neither jax nor the JAX package, so
it also runs on a GPU machine that has no JAX (without the suite's
conftest.py, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.kernels.fused_render import (
    fused_render_rays,
    fused_render_rays_plain,
    k1_uses_tensor_cores,
)
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim


def _rays(n, seed, device):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.randn(n, 3).astype(np.float32)
    # Non-unit lengths: the deltas scale with ||d||.
    rd *= rng.uniform(0.5, 2.0, (n, 1)) / np.linalg.norm(rd, axis=-1, keepdims=True)
    return torch.from_numpy(ro).to(device), torch.from_numpy(rd).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples,hidden,num_freqs,mma", [
    (64, 128, 10, True), (16, 32, 4, True),
    (48, 64, 10, True),    # 96 points padded to the tensor cores' 128 rows
    (64, 48, 10, False),   # bf16 off the tensor cores' layout: the CUDA cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, n_samples, hidden, num_freqs, mma, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(2), device=cuda_device)
    ro, rd = _rays(1001, 6, cuda_device)  # not a multiple of any tile
    kw = dict(n_samples=n_samples, num_freqs=num_freqs)
    mma = mma and dtype == torch.bfloat16  # f32: the CUDA cores
    assert k1_uses_tensor_cores(cfg, n_samples) is mma
    before = (fused_render_rays.launches, fused_render_rays.mma_launches)
    with torch.no_grad():
        got = fused_render_rays(model, ro, rd, **kw)
        torch.cuda.synchronize()
        want = fused_render_rays_plain(model, ro, rd, **kw)
    assert (fused_render_rays.launches, fused_render_rays.mma_launches) == (
        before[0] + 1, before[1] + int(mma))
    err = (got - want).abs().max(dim=1).values
    # f32: summation order only; bf16: the render parity gates.
    p999 = 5e-4 if dtype == torch.float32 else 3e-2
    assert float(torch.quantile(err, 0.999)) < p999
    assert float((err > 3e-2).float().mean()) < 2.5e-3
    if dtype == torch.bfloat16:
        assert float(err.mean()) < 1e-3


def _train_case(n_samples, hidden, num_freqs, dtype, device, n_rays=256, seed=3):
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    ro, rd = _rays(n_rays, seed, device)
    target = torch.from_numpy(np.random.RandomState(seed).rand(n_rays, 3).astype(np.float32))
    return model, ro, rd, target.to(device)


def _cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("n_samples,hidden,num_freqs,noise", [
    (64, 128, 10, False), (16, 32, 4, False),
    (48, 64, 10, False),  # bf16 tiles of 48 points: the CUDA cores
    (64, 128, 10, True),
    (64, 48, 10, False),  # bf16 hidden 48: the CUDA cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_matches_plain_on_card(cuda_device, n_samples, hidden, num_freqs, noise, dtype):
    from tinynerf_tpu_torch.kernels.fused_train import (
        fused_loss_grads,
        fused_loss_grads_plain,
        k2_uses_tensor_cores,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model, ro, rd, target = _train_case(n_samples, hidden, num_freqs, dtype, cuda_device)
    sigma_noise = None
    if noise:
        g = torch.Generator(device=cuda_device).manual_seed(4)
        sigma_noise = torch.randn(ro.shape[0], n_samples, generator=g, device=cuda_device)
    kw = dict(n_samples=n_samples, num_freqs=num_freqs, randomized=False, sigma_noise=sigma_noise)
    mma = k2_uses_tensor_cores(model.cfg, n_samples)
    assert mma is (dtype == torch.bfloat16 and n_samples in (64, 16) and hidden != 48)
    before = (fused_loss_grads.launches, fused_loss_grads.mma_launches)
    loss, grads = fused_loss_grads(model, ro, rd, target, 0, **kw)
    torch.cuda.synchronize()
    want_loss, want = fused_loss_grads_plain(model, ro, rd, target, 0, **kw)
    assert (fused_loss_grads.launches, fused_loss_grads.mma_launches) == (
        before[0] + 1, before[1] + int(mma))
    rel = abs(float(loss) - float(want_loss)) / float(want_loss)
    if dtype == torch.float32:
        # Summation order only: the JAX package's own kernel tolerance.
        assert rel < 1e-5
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= 2e-4 * float(w.abs().max()) + 1e-8
    else:
        # bf16 rounds at other places than autograd: bench.py's gates; on
        # the tensor cores each trunk leaf also by its scale.
        assert rel < 1e-3
        assert min(_cosine(g, w) for g, w in zip(grads, want)) > 0.98
        _scale_check([n for n, _ in model.named_parameters()], grads, want)


@pytest.mark.cuda
def test_train_kernel_on_tensor_cores_sums_many_tiles_a_block_on_card(cuda_device):
    """bf16 K2 on the tensor cores with about 8 tiles a block (1056 rays of
    64 samples over at most 132 blocks): each block's first tile writes its
    partial row and the later ones add to it. The bf16 gates with each
    trunk leaf's scale, and a second launch bit-identical (no earlier
    launch's row leaks in)."""
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads, fused_loss_grads_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    model, ro, rd, target = _train_case(64, 128, 10, torch.bfloat16, cuda_device, n_rays=1056,
                                        seed=9)
    kw = dict(n_samples=64, num_freqs=10, randomized=False)
    mma0 = fused_loss_grads.mma_launches
    runs = [fused_loss_grads(model, ro, rd, target, 0, **kw) for _ in range(2)]
    assert fused_loss_grads.mma_launches == mma0 + 2
    (l0, g0), (l1, g1) = [(float(l), [g.clone() for g in gs]) for l, gs in runs]
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    want_loss, want = fused_loss_grads_plain(model, ro, rd, target, 0, **kw)
    assert abs(l0 - float(want_loss)) / float(want_loss) < 1e-3
    assert min(_cosine(g, w) for g, w in zip(g0, want)) > 0.98
    _scale_check([n for n, _ in model.named_parameters()], g0, want)


@pytest.mark.cuda
def test_k1_and_k2_refuse_fragments_off_their_route_on_card(cuda_device):
    """K1's and K2's C entries run the tensor-core kernel only for a bf16
    launch at its shapes: fragments with an f32 launch, at hidden 48, or
    (K1) over 128 points a tile or (K2) with tiles of 48 points come back
    as cudaErrorInvalidValue before anything runs. K2's other arguments
    (n_grad, its partial row, each scene's weight strides) are right for
    each shape, one scene and two, so the route rule alone refuses."""
    from tinynerf_tpu_torch.kernels import fused_render as k1
    from tinynerf_tpu_torch.kernels import fused_train as k2

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    frag = torch.zeros(4, dtype=torch.bfloat16, device=cuda_device).data_ptr()
    # (tile_rays, n_samples, hidden, bf16)
    for tile, S, hidden, bf16 in ((2, 64, 128, 0), (2, 64, 48, 1), (1, 192, 128, 1)):
        err = k1._lib().tinynerf_fused_render(None, None, None, frag, None, 2 * tile, tile, S, S,
                                              0, 10, hidden, 4, 2, 2.0, 6.0, bf16,
                                              cuda_device.index, stream)
        assert err != 0, (tile, S, hidden, bf16)
    for tile, S, hidden, bf16 in ((1, 64, 128, 0), (1, 64, 48, 1), (1, 48, 128, 1)):
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=hidden, depth=4, skip_at=2)
        w_fwd, w_mma = k1.pack_tiny_weights(TinyNeRF(cfg), cfg, mma=True, upstream=True)
        n_grad = w_fwd.numel()
        slab = lambda n: -(-n // 4) * 4  # noqa: E731
        for n_scenes in (1, 2):
            err = k2._lib().tinynerf_fused_train(
                None, None, None, None, None, None, None, frag, None, None, None, 132, tile, S,
                10, hidden, 4, 2, 2.0, 0.1, 0.01, 0, 1, bf16, 132, n_grad, k2.partial_row(n_grad),
                n_scenes, slab(n_grad), 0, slab(w_mma.numel()), 0, None, cuda_device.index,
                stream)
            assert err == 1, (tile, S, hidden, bf16, n_scenes)  # cudaErrorInvalidValue


@pytest.mark.cuda
def test_train_kernel_is_deterministic_and_seeded(cuda_device):
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads

    model, ro, rd, target = _train_case(64, 128, 10, torch.bfloat16, cuda_device, n_rays=512)
    runs = [fused_loss_grads(model, ro, rd, target, seed) for seed in (7, 7, 8)]
    (l0, g0), (l1, g1), (l2, g2) = [(float(l), [g.clone() for g in gs]) for l, gs in runs]
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert l0 != l2 and not torch.equal(g0[0], g2[0])


@pytest.mark.cuda
def test_jitter_probe_bins_and_uniformity(cuda_device):
    from tinynerf_tpu_torch.kernels.fused_train import depth_grid, jitter_probe

    R, S, near, far = 4096, 64, 2.0, 6.0
    z = jitter_probe(123, R, S, near, far, tile=1, device=cuda_device)
    assert torch.equal(z, jitter_probe(123, R, S, near, far, tile=8, device=cuda_device))
    assert torch.equal(z, jitter_probe(123, R, S, near, far, tile=1, device=cuda_device))
    assert (z != jitter_probe(124, R, S, near, far, tile=1, device=cuda_device)).float().mean() > 0.99
    grid = depth_grid(S, near, far, cuda_device)
    h = (far - near) / (S - 1)
    s = torch.arange(S, device=cuda_device)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == S - 1, grid, grid + 0.5 * h)
    assert bool(((z >= lower) & (z <= upper)).all())
    u = ((z - lower) / (upper - lower)).double()
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 6 / (12 * n) ** 0.5
    assert abs(float(u.var()) - 1 / 12) < 6 * (1 / 180 / n) ** 0.5
    counts = torch.histc(u.float(), bins=10, min=0.0, max=1.0)
    assert float((counts / n - 0.1).abs().max()) < 6 * (0.09 / n) ** 0.5
    corr = torch.corrcoef(torch.stack([u[:-1].reshape(-1), u[1:].reshape(-1)]))[0, 1]
    assert abs(float(corr)) < 6 / n ** 0.5


def _nerf_case(hidden, num_freqs, dir_freqs, use_viewdirs, dtype, device, seed=5):
    from tinynerf_tpu_torch.models.nerf import NeRFMLP, NeRFConfig

    # hidden 48 (rgb_hidden 24): a bf16 width off the tensor cores' layout.
    depth, skip_at, rgb_hidden = (8, 4, 64) if hidden >= 128 else (3, 2, 24 if hidden == 48 else 16)
    cfg = NeRFConfig(num_freqs=num_freqs, num_freqs_dir=dir_freqs, hidden=hidden, depth=depth,
                     skip_at=skip_at, rgb_hidden=rgb_hidden, use_viewdirs=use_viewdirs,
                     compute_dtype=dtype)
    return NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed), device=device), cfg


def _sorted_z(n, S, seed, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(np.sort(rng.uniform(2.0, 6.0, (n, S)).astype(np.float32), axis=1)).to(device)


def _within_render_gates(got, want, dtype):
    """Per-ray max error: f32 p99.9 < 5e-4; bf16 p99.9 < 3e-2, mean < 1e-3;
    both: fraction above 3e-2 (last-sample flips) < 2.5e-3."""
    err = (got - want).abs().reshape(got.shape[0], -1).max(dim=1).values
    p999 = 5e-4 if dtype == torch.float32 else 3e-2
    assert float(torch.quantile(err, 0.999)) < p999
    if dtype == torch.bfloat16:
        assert float(err.mean()) < 1e-3
    assert float((err > 3e-2).float().mean()) < 2.5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs,S,given_z", [
    (256, 10, 4, True, 64, False),   # the flagship's coarse pass
    (256, 10, 4, True, 192, True),   # the flagship's fine pass
    (32, 4, 2, True, 16, False),
    (128, 10, 4, False, 24, True),
    (32, 4, 2, True, 7, True),       # S odd: a tile of 64 rays, partial chunks
    (48, 4, 2, True, 16, True),      # bf16 off the tensor cores' widths: the CUDA cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_kernel_matches_plain_on_card(cuda_device, hidden, num_freqs, dir_freqs, viewdirs, S,
                                           given_z, dtype):
    """Each bf16 launch at hidden 32, 128 or 256 runs on the tensor cores
    (one .mma_launches more), f32 and bf16 at hidden 48 on the CUDA cores
    (none); all within the render gates."""
    from tinynerf_tpu_torch.kernels.fused_nerf import fused_nerf_render_rays, fused_nerf_render_rays_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    mlp, cfg = _nerf_case(hidden, num_freqs, dir_freqs, viewdirs, dtype, cuda_device)
    ro, rd = _rays(1001, 8, cuda_device)
    z = _sorted_z(1001, S, 9, cuda_device) if given_z else None
    kw = dict(n_samples=S, cfg=cfg, return_weights=True)
    k3 = fused_nerf_render_rays
    before = (k3.launches, k3.mma_launches)
    with torch.no_grad():
        got, got_w = k3(mlp, ro, rd, z, **kw)
        torch.cuda.synchronize()
        want, want_w = fused_nerf_render_rays_plain(mlp, ro, rd, z, **kw)
    on_tensor_cores = dtype == torch.bfloat16 and hidden != 48
    assert (k3.launches, k3.mma_launches) == (before[0] + 1, before[1] + on_tensor_cores)
    assert got.shape == (1001, 3) and got_w.shape == (1001, S)
    assert bool(torch.isfinite(got).all() and torch.isfinite(got_w).all())
    _within_render_gates(got, want, dtype)
    _within_render_gates(got_w, want_w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,S,sample_block", [
    (128, 10, 4, 512, 64),   # the --n-fine 448 recipe's fine pass
    (32, 4, 2, 24, 8),
    (32, 4, 2, 16, 16),
    (48, 4, 2, 24, 8),       # bf16 off the tensor cores' widths: the CUDA cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_kernel_matches_plain_on_card(cuda_device, hidden, num_freqs, dir_freqs, S,
                                               sample_block, dtype):
    """K3's route: one .mma_launches more for each bf16 launch at a
    tensor-core width, none for f32 or hidden 48."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_render_rays_streamed,
        fused_nerf_render_rays_streamed_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mlp, cfg = _nerf_case(hidden, num_freqs, dir_freqs, True, dtype, cuda_device)
    ro, rd = _rays(777, 10, cuda_device)
    z = _sorted_z(777, S, 11, cuda_device)
    kw = dict(cfg=cfg, sample_block=sample_block)
    k5 = fused_nerf_render_rays_streamed
    before = (k5.launches, k5.mma_launches)
    with torch.no_grad():
        got = k5(mlp, ro, rd, z, **kw)
        torch.cuda.synchronize()
        want = fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z, **kw)
    on_tensor_cores = dtype == torch.bfloat16 and hidden != 48
    assert (k5.launches, k5.mma_launches) == (before[0] + 1, before[1] + on_tensor_cores)
    assert got.shape == (777, 3) and bool(torch.isfinite(got).all())
    _within_render_gates(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sample_block", [8, 64, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_kernel_equals_monolithic_kernel_on_card(cuda_device, sample_block, dtype):
    """On the same z both kernels run the same MLP code (in bf16 both on
    the tensor cores), so the per-point values are equal and only the
    order of the transmittance products and colour sums differs: <= 192 *
    2^-24 relative on each, so at most ~2.3e-5 on a colour in [0, 1] plus
    its background term."""
    from tinynerf_tpu_torch.kernels.fused_nerf import fused_nerf_render_rays
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_render_rays_streamed

    mlp, cfg = _nerf_case(256, 10, 4, True, dtype, cuda_device)
    ro, rd = _rays(600, 12, cuda_device)
    z = _sorted_z(600, 192, 13, cuda_device)
    before = fused_nerf_render_rays.mma_launches + fused_nerf_render_rays_streamed.mma_launches
    with torch.no_grad():
        mono = fused_nerf_render_rays(mlp, ro, rd, z, cfg=cfg)
        stream = fused_nerf_render_rays_streamed(mlp, ro, rd, z, cfg=cfg, sample_block=sample_block)
    after = fused_nerf_render_rays.mma_launches + fused_nerf_render_rays_streamed.mma_launches
    assert after - before == (2 if dtype == torch.bfloat16 else 0)
    assert float((mono - stream).abs().max()) < 2.5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("sample_block,want_k5", [(None, 0), (8, 1)])
def test_hierarchical_pipeline_on_card(cuda_device, sample_block, want_k5):
    """The fused pipeline against the eager render on the card, f32: the
    coarse pass always on K3, the fine pass on K3 or, with a forced block,
    on K5; the resampled depths inherit the kernels' rounding (1e-3, the
    JAX package's pipeline tolerance)."""
    from tinynerf_tpu_torch.kernels.fused_nerf import fused_nerf_render_rays, fused_render_rays_hierarchical
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_render_rays_streamed
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, render_rays_hierarchical

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16,
                     compute_dtype=torch.float32)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(3), device=cuda_device)
    ro, rd = _rays(300, 14, cuda_device)
    k3, k5 = fused_nerf_render_rays.launches, fused_nerf_render_rays_streamed.launches
    with torch.no_grad():
        got = fused_render_rays_hierarchical(model, ro, rd, n_coarse=16, n_fine=8, cfg=cfg,
                                             sample_block=sample_block)
        want = render_rays_hierarchical(model, ro, rd, n_coarse=16, n_fine=8, cfg=cfg)
    assert fused_nerf_render_rays.launches - k3 == 2 - want_k5
    assert fused_nerf_render_rays_streamed.launches - k5 == want_k5
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-3


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device):
    """A launch the card refuses (here: hidden 1024 on the one-round route,
    2048 threads a block) comes back as a CUDA error code, and the
    wrapper's check turns it into an exception; nothing runs."""
    from tinynerf_tpu_torch.kernels.fused_nerf import _lib, raise_on_error

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    err = _lib().tinynerf_fused_nerf(None, None, None, None, None, None, None, 128, 1, 64, 10, 4,
                                     1, 1024, 8, 4, 64, 2.0, 6.0, 0, 0, None, 1,
                                     cuda_device.index, stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        raise_on_error(err, "fused_nerf")
    # Tensor-core fragments with an f32 launch, or at a width off their
    # layout (hidden 48), are refused before anything runs.
    frag = torch.zeros(4, dtype=torch.bfloat16, device=cuda_device)
    for hidden, rgb_hidden, bf16 in ((256, 64, 0), (48, 24, 1)):
        err = _lib().tinynerf_fused_nerf(None, None, None, None, frag.data_ptr(), None, None, 128,
                                         1, 64, 10, 4, 1, hidden, 8, 4, rgb_hidden, 2.0, 6.0, bf16,
                                         0, None, 1, cuda_device.index, stream)
        assert err != 0


def _plain(fn, mlp, *args, dtype, **kw):
    """The plain version's (loss, grads, slack). bf16: as it is. f32: with
    float64 sums (a float64 copy of the MLP: the points, the encoding and
    the deltas stay f32), slack = each leaf's max |f32 plain - float64
    plain|, the error the straightforward f32 evaluation itself makes
    (chip_smoke.py phase 17 gives its size)."""
    import copy

    if dtype == torch.bfloat16:
        out = fn(mlp, *args, **kw)
        return out[0], out[1], None
    out32 = fn(mlp, *args, **kw)
    out = fn(copy.deepcopy(mlp).double(), *args, **kw)
    want = [g.float() for g in out[1]]
    return out[0].float(), want, [float((a - b).abs().max()) for a, b in zip(out32[1], want)]


# bf16 K4, K6 and K7's backward: each trunk and rgb_in leaf (the
# tensor-core products' output) within this of 1 in its scale along the
# reference, <g, w> / <w, w>; chip_smoke.py's MMA_SCALE. The cosine gate
# does not see a scale.
MMA_SCALE = 0.01


def _scale_check(names, grads, want):
    for n, g, w in zip(names, grads, want):
        if n.startswith(("layers.", "rgb_in.")):
            scale = float((g * w).sum() / (w * w).sum().clamp_min(1e-30))
            assert abs(scale - 1) < MMA_SCALE, (n, scale)


def _leaf_check(loss, grads, ref, dtype, names=None):
    """f32: loss rel. error < 1e-5 and every leaf within 3e-4 of its max
    (the JAX package's kernel tolerance, tests/test_fused_nerf_train.py)
    plus the f32 plain version's own error, capped at another 3e-4 of
    the max, against float64 sums; bf16: loss rel. error < 1e-3 and worst
    leaf cosine > 0.98 (bench.py), and with the leaves' `names` (the
    tensor-core walk) each trunk and rgb_in leaf's scale within MMA_SCALE
    of 1."""
    want_loss, want, slack = ref
    rel = abs(float(loss) - float(want_loss)) / float(want_loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    if dtype == torch.float32:
        assert rel < 1e-5
        for g, w, sl in zip(grads, want, slack):
            tol = 3e-4 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol + min(sl, tol) + 1e-8
    else:
        assert rel < 1e-3
        assert min(_cosine(g, w) for g, w in zip(grads, want)) > 0.98
        _scale_check(names or [], grads, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs,S,given_z,noise", [
    (256, 10, 4, True, 64, False, False),   # the flagship's coarse pass
    (128, 10, 4, True, 128, True, False),   # hidden 128: the fine pass on a 128-sample union
    (32, 4, 2, True, 16, False, True),
    (64, 10, 4, False, 24, True, False),
    (32, 4, 2, True, 7, True, False),       # S odd: a tile of 128 rays
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_train_kernel_matches_plain_on_card(cuda_device, hidden, num_freqs, dir_freqs,
                                                 viewdirs, S, given_z, noise, dtype):
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mlp, cfg = _nerf_case(hidden, num_freqs, dir_freqs, viewdirs, dtype, cuda_device)
    n = 300  # not a multiple of any tile: padding rays
    ro, rd = _rays(n, 15, cuda_device)
    target = torch.from_numpy(np.random.RandomState(16).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, S, 17, cuda_device) if given_z else None
    sigma_noise = None
    if noise:
        g = torch.Generator(device=cuda_device).manual_seed(4)
        sigma_noise = torch.randn(n, S, generator=g, device=cuda_device)
    kw = dict(n_samples=S, randomized=False, sigma_noise=sigma_noise, emit_sampling=True, cfg=cfg)
    k4 = fused_nerf_pass_grads
    before = (k4.launches, k4.mma_launches)
    loss, grads, w, zs = k4(mlp, ro, rd, target, 0, z, **kw)
    torch.cuda.synchronize()
    _, _, want_w, want_z = fused_nerf_pass_grads_plain(mlp, ro, rd, target, 0, z, **kw)
    ref = _plain(fused_nerf_pass_grads_plain, mlp, ro, rd, target, 0, z, dtype=dtype, **kw)
    assert (k4.launches - before[0], k4.mma_launches - before[1]) == (1, int(dtype == torch.bfloat16))
    assert w.shape == (n, S) and torch.equal(zs, want_z)
    _leaf_check(loss, grads, ref, dtype, names=[n for n, _ in mlp.named_parameters()])
    _within_render_gates(w, want_w, dtype)


@pytest.mark.cuda
def test_nerf_train_kernel_on_tensor_cores_at_flagship_on_card(cuda_device):
    """K4 in bf16 at the flagship coarse pass (hidden 256, L 10, L_dir 4,
    S=64 jittered in the kernel, 128 rays) takes the tensor-core walk: two
    launches with one seed are bit-identical (loss, gradients, weights,
    depths), and on the depths it drew it passes the bf16 gates and the
    tensor-core leaves' scale against its plain version."""
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
    )

    k4 = fused_nerf_pass_grads
    mlp, cfg = _nerf_case(256, 10, 4, True, torch.bfloat16, cuda_device)
    n = 128
    ro, rd = _rays(n, 42, cuda_device)
    target = torch.from_numpy(np.random.RandomState(43).rand(n, 3).astype(np.float32)).to(cuda_device)
    before = (k4.launches, k4.mma_launches)
    runs = []
    for _ in range(2):
        out = k4(mlp, ro, rd, target, 11, n_samples=64, emit_sampling=True, cfg=cfg)
        runs.append([out[0].clone(), *[g.clone() for g in out[1]], out[2].clone(), out[3].clone()])
    torch.cuda.synchronize()
    assert (k4.launches - before[0], k4.mma_launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    z = runs[0][-1]
    ref = _plain(fused_nerf_pass_grads_plain, mlp, ro, rd, target, 0, z, dtype=torch.bfloat16,
                 randomized=False, cfg=cfg)
    _leaf_check(runs[0][0], runs[0][1:-2], ref, torch.bfloat16,
                names=[n for n, _ in mlp.named_parameters()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_train_kernel_counts_tensor_core_launches_on_card(cuda_device, dtype):
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads

    k4 = fused_nerf_pass_grads
    mlp, cfg = _nerf_case(32, 4, 2, True, dtype, cuda_device)
    ro, rd = _rays(64, 44, cuda_device)
    before = (k4.launches, k4.mma_launches)
    k4(mlp, ro, rd, torch.full((64, 3), 0.5, device=cuda_device), 3, n_samples=16, cfg=cfg)
    torch.cuda.synchronize()
    assert (k4.launches - before[0], k4.mma_launches - before[1]) == (1, int(dtype == torch.bfloat16))


def _off_tensor_core_width(device):
    """hidden 64 with rgb_hidden 8: the CUDA-core walk takes it, but the
    bf16 tensor-core walk cannot share rgb_in's 8 columns over its warps,
    so bf16 routes to the CUDA-core walk."""
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP

    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=64, depth=3, skip_at=2, rgb_hidden=8,
                     compute_dtype=torch.bfloat16)
    return NeRFMLP(cfg, generator=torch.Generator().manual_seed(0), device=device), cfg


@pytest.mark.cuda
def test_nerf_train_kernel_refuses_widths_off_the_tensor_cores_on_card(cuda_device):
    """A bf16 K4 launch at a width the tensor-core walk cannot take routes
    to the CUDA-core walk by configuration (it used to be refused): it
    launches once, none on the tensor cores, and on the depths it drew
    meets the bf16 gates against its plain version."""
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
        uses_tensor_cores,
    )

    k4 = fused_nerf_pass_grads
    mlp, cfg = _off_tensor_core_width(cuda_device)
    assert uses_tensor_cores(cfg) is False
    n = 128
    ro, rd = _rays(n, 45, cuda_device)
    target = torch.from_numpy(np.random.RandomState(45).rand(n, 3).astype(np.float32)).to(cuda_device)
    before = (k4.launches, k4.mma_launches)
    loss, grads, _, z = k4(mlp, ro, rd, target, 0, n_samples=16, emit_sampling=True, cfg=cfg)
    torch.cuda.synchronize()
    assert (k4.launches - before[0], k4.mma_launches - before[1]) == (1, 0)
    ref = _plain(fused_nerf_pass_grads_plain, mlp, ro, rd, target, 0, z, dtype=torch.bfloat16,
                 randomized=False, cfg=cfg)
    _leaf_check(loss, grads, ref, torch.bfloat16, names=[n for n, _ in mlp.named_parameters()])


@pytest.mark.cuda
def test_nerf_train_kernel_refuses_a_tensor_core_width_without_fragments_on_card(cuda_device,
                                                                                  monkeypatch):
    """The C entry checks the route again: a bf16 launch at a width the
    tensor-core walk takes, handed no fragments (the CUDA-core route
    forced in Python), is refused with cudaErrorInvalidValue, never run
    on the CUDA cores."""
    from tinynerf_tpu_torch.kernels import fused_nerf_train

    mlp, cfg = _nerf_case(32, 4, 2, True, torch.bfloat16, cuda_device)
    assert fused_nerf_train.uses_tensor_cores(cfg) is True
    monkeypatch.setattr(fused_nerf_train, "uses_tensor_cores", lambda cfg: False)
    ro, rd = _rays(64, 49, cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_nerf_train.fused_nerf_pass_grads(mlp, ro, rd, torch.zeros(64, 3, device=cuda_device),
                                               0, n_samples=16, cfg=cfg)


@pytest.mark.cuda
def test_nerf_train_kernel_jitter_is_seeded_and_binned(cuda_device):
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads
    from tinynerf_tpu_torch.kernels.fused_train import depth_grid

    mlp, cfg = _nerf_case(32, 4, 2, True, torch.bfloat16, cuda_device)
    n, S = 512, 64
    ro, rd = _rays(n, 18, cuda_device)
    target = torch.full((n, 3), 0.5, device=cuda_device)
    runs = [fused_nerf_pass_grads(mlp, ro, rd, target, seed, n_samples=S, emit_sampling=True,
                                  cfg=cfg) for seed in (7, 7, 8)]
    (l0, g0, _, z0), (l1, g1, _, z1), (l2, g2, _, z2) = [
        (float(r[0]), [g.clone() for g in r[1]], r[2], r[3].clone()) for r in runs]
    assert l0 == l1 and torch.equal(z0, z1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert l0 != l2 and (z0 != z2).float().mean() > 0.99
    grid = depth_grid(S, 2.0, 6.0, cuda_device)
    h = 4.0 / (S - 1)
    s = torch.arange(S, device=cuda_device)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == S - 1, grid, grid + 0.5 * h)
    assert bool(((z0 >= lower) & (z0 <= upper)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,S,sample_block,noise", [
    (256, 10, 4, 192, 64, False),  # the flagship's fine pass
    (128, 10, 4, 512, 64, False),  # the --n-fine 448 recipe's fine pass
    (32, 4, 2, 24, 8, True),
    (32, 4, 2, 16, 16, False),     # one block
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_train_kernel_matches_plain_on_card(cuda_device, hidden, num_freqs, dir_freqs, S,
                                                     sample_block, noise, dtype):
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mlp, cfg = _nerf_case(hidden, num_freqs, dir_freqs, True, dtype, cuda_device)
    n = 257
    ro, rd = _rays(n, 19, cuda_device)
    target = torch.from_numpy(np.random.RandomState(20).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, S, 21, cuda_device)
    sigma_noise = None
    if noise:
        g = torch.Generator(device=cuda_device).manual_seed(5)
        sigma_noise = torch.randn(n, S, generator=g, device=cuda_device)
    kw = dict(cfg=cfg, sample_block=sample_block, sigma_noise=sigma_noise)
    before = fused_nerf_pass_grads_streamed.launches
    loss, grads = fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, **kw)
    torch.cuda.synchronize()
    ref = _plain(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z, dtype=dtype, **kw)
    assert fused_nerf_pass_grads_streamed.launches == before + 1
    _leaf_check(loss, grads, ref, dtype, names=[n for n, _ in mlp.named_parameters()])


@pytest.mark.cuda
def test_streamed_train_kernel_on_tensor_cores_at_flagship_on_card(cuda_device):
    """K6 in bf16 at the flagship width (hidden 256, L 10, L_dir 4, S=192,
    block 64, 128 rays) takes the tensor-core walk: under the bf16 gates
    and the tensor-core leaves' scale against its plain version, and two
    launches are bit-identical."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
    )

    k6 = fused_nerf_pass_grads_streamed
    mlp, cfg = _nerf_case(256, 10, 4, True, torch.bfloat16, cuda_device)
    n = 128
    ro, rd = _rays(n, 35, cuda_device)
    target = torch.from_numpy(np.random.RandomState(36).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 192, 37, cuda_device)
    before = (k6.launches, k6.mma_launches)
    runs = []
    for _ in range(2):
        loss, grads = k6(mlp, ro, rd, target, z, cfg=cfg, sample_block=64)
        runs.append((loss.clone(), [g.clone() for g in grads]))
    torch.cuda.synchronize()
    assert (k6.launches - before[0], k6.mma_launches - before[1]) == (2, 2)
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    ref = _plain(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z,
                 dtype=torch.bfloat16, cfg=cfg, sample_block=64)
    _leaf_check(l0, g0, ref, torch.bfloat16, names=[n for n, _ in mlp.named_parameters()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_train_kernel_counts_tensor_core_launches_on_card(cuda_device, dtype):
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed

    k6 = fused_nerf_pass_grads_streamed
    mlp, cfg = _nerf_case(32, 4, 2, True, dtype, cuda_device)
    ro, rd = _rays(64, 38, cuda_device)
    target = torch.full((64, 3), 0.5, device=cuda_device)
    before = (k6.launches, k6.mma_launches)
    k6(mlp, ro, rd, target, _sorted_z(64, 16, 39, cuda_device), cfg=cfg, sample_block=16)
    torch.cuda.synchronize()
    assert (k6.launches - before[0], k6.mma_launches - before[1]) == (1, int(dtype == torch.bfloat16))


@pytest.mark.cuda
def test_streamed_train_kernel_refuses_widths_off_the_tensor_cores_on_card(cuda_device):
    """hidden 64 with rgb_hidden 8: the bf16 tensor-core walk cannot share
    rgb_in's 8 columns over its warps, so bf16 K6 routes to the CUDA-core
    walk by configuration (it used to be refused): one launch, none on the
    tensor cores, within the bf16 gates of its plain version."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
    )

    k6 = fused_nerf_pass_grads_streamed
    mlp, cfg = _off_tensor_core_width(cuda_device)
    n = 128
    ro, rd = _rays(n, 40, cuda_device)
    target = torch.from_numpy(np.random.RandomState(40).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 32, 41, cuda_device)
    before = (k6.launches, k6.mma_launches)
    loss, grads = k6(mlp, ro, rd, target, z, cfg=cfg, sample_block=16)
    torch.cuda.synchronize()
    assert (k6.launches - before[0], k6.mma_launches - before[1]) == (1, 0)
    ref = _plain(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z,
                 dtype=torch.bfloat16, cfg=cfg, sample_block=16)
    _leaf_check(loss, grads, ref, torch.bfloat16, names=[n for n, _ in mlp.named_parameters()])


@pytest.mark.cuda
@pytest.mark.parametrize("sample_block", [8, 64])
def test_streamed_train_kernel_equals_monolithic_on_card(cuda_device, sample_block):
    """Same union, same MLP code: the losses agree to 1e-6 relative and
    the gradients to 1e-5 of each leaf's max, the JAX package's gates
    for the same pair (tests/test_fused_nerf_stream.py:117-128)."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
    from tinynerf_tpu_torch.kernels.fused_nerf_train import fused_nerf_pass_grads

    mlp, cfg = _nerf_case(128, 10, 4, True, torch.float32, cuda_device)
    n = 256
    ro, rd = _rays(n, 22, cuda_device)
    target = torch.from_numpy(np.random.RandomState(23).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 192, 24, cuda_device)
    l_mono, g_mono = fused_nerf_pass_grads(mlp, ro, rd, target, 0, z, randomized=False, cfg=cfg)
    l_str, g_str = fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, cfg=cfg,
                                                  sample_block=sample_block)
    assert abs(float(l_str) - float(l_mono)) <= 1e-6 * float(l_mono)
    for a, b in zip(g_str, g_mono):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("sample_block,want_k6", [(None, 0), (8, 1)])
def test_hierarchical_grad_fn_on_card(cuda_device, sample_block, want_k6):
    """The fused step against autograd of the eager hierarchical loss,
    deterministic depths, f32: the coarse pass on K4, the fine pass on K4
    or, with a forced block, on K6; the JAX package's gradient gate for
    the same pipeline (3e-4 of each leaf's max)."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        make_fused_nerf_grad_fn,
    )
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, render_rays_hierarchical
    from tinynerf_tpu_torch.training import TrainSettings

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16,
                     compute_dtype=torch.float32)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(3), device=cuda_device)
    n = 128
    ro, rd = _rays(n, 25, cuda_device)
    target = torch.from_numpy(np.random.RandomState(26).rand(n, 3).astype(np.float32)).to(cuda_device)
    s = TrainSettings(n_rand=n, n_samples=16, num_freqs=4)
    comp_c, comp_f = render_rays_hierarchical(model, ro, rd, n_coarse=16, n_fine=8, cfg=cfg)
    ref = torch.mean((comp_c - target) ** 2) + torch.mean((comp_f - target) ** 2)
    want = torch.autograd.grad(ref, list(model.parameters()))
    ref = ref.detach()
    k4, k6 = fused_nerf_pass_grads.launches, fused_nerf_pass_grads_streamed.launches
    grad_fn = make_fused_nerf_grad_fn(s, cfg, n_fine=8, randomized=False, sample_block=sample_block)
    loss_f, metrics = grad_fn(model, ro, rd, target, torch.Generator(device=cuda_device))
    assert fused_nerf_pass_grads.launches - k4 == 2 - want_k6
    assert fused_nerf_pass_grads_streamed.launches - k6 == want_k6
    assert abs(float(metrics["loss_coarse"]) + float(loss_f) - float(ref)) < 1e-6
    for p, w in zip(model.parameters(), want):
        assert float((p.grad - w).abs().max()) <= 3e-4 * float(w.abs().max()) + 1e-8


def _partials_case(hidden, num_freqs, dir_freqs, viewdirs, S, dtype, device, n=300, seed=27):
    """One shard's inputs: sorted depths, their global deltas sliced to the
    second half of a 2S union (so the terminal 1e10 delta is in), and
    sigma-noise."""
    from tinynerf_tpu_torch.ops.volume import global_deltas

    mlp, cfg = _nerf_case(hidden, num_freqs, dir_freqs, viewdirs, dtype, device, seed=seed)
    ro, rd = _rays(n, seed, device)
    z_union = _sorted_z(n, 2 * S, seed + 1, device)
    deltas = global_deltas(z_union, rd)
    z, deltas = z_union[:, S:].contiguous(), deltas[:, S:].contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    noise = 0.5 * torch.randn(n, S, generator=g, device=device)
    return mlp, cfg, ro, rd, z, deltas, noise


def _partials_cotangents(n, S, device, seed=31, signed=True):
    """Random cotangents of C, A, T, D and the local weights, g_T and g_w
    nonzero: N(0, 1) / n, or with signed=False U[0.5, 1.5) / n (one sign:
    no leaf's sum cancels, so its scale is well conditioned)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        if signed:
            return torch.randn(*shape, generator=g, device=device) / n
        return (0.5 + torch.rand(*shape, generator=g, device=device)) / n

    cot = {k: draw(*shape) for k, shape in (("C", (n, 3)), ("A", (n,)), ("T", (n,)), ("D", (n,)))}
    return cot, draw(n, S)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs,S,sample_block,emit", [
    (256, 10, 4, True, 96, 48, False),   # the flagship's fine shard at world 2
    (256, 10, 4, True, 32, 32, True),    # the flagship's coarse shard, weights out
    (32, 4, 2, True, 16, 4, True),
    (64, 10, 4, False, 24, 8, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_kernels_match_plain_on_card(cuda_device, hidden, num_freqs, dir_freqs, viewdirs,
                                              S, sample_block, emit, dtype):
    """K7's forward (partials, local weights) under the render gates and its
    backward (parameter gradients from random cotangents, g_T and g_w
    included) under the NeRF pass gates, against the plain versions; bf16
    (the tensor-core walk) also each trunk and rgb_in leaf's scale, with
    one-signed cotangents."""
    import copy

    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain,
        block_partials_plain,
        fused_block_partials_bwd,
        fused_block_partials_fwd,
        make_fused_block_partials_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mlp, cfg, ro, rd, z, deltas, noise = _partials_case(hidden, num_freqs, dir_freqs, viewdirs, S,
                                                        dtype, cuda_device)
    n = ro.shape[0]
    cot, g_w = _partials_cotangents(n, S, cuda_device)
    g_w = g_w if emit else None
    fn = make_fused_block_partials_fn(cfg, emit_weights=emit, sample_block=sample_block)
    k7 = (fused_block_partials_fwd, fused_block_partials_bwd)
    before = [(k.launches, k.mma_launches) for k in k7]

    def through_kernels(cot, g_w):
        partials, w = fn(mlp, ro, rd, z, deltas, noise)
        outs = [partials[k] for k in ("C", "A", "T", "D")] + ([w] if emit else [])
        cots = [cot[k] for k in ("C", "A", "T", "D")] + ([g_w] if emit else [])
        grads = torch.autograd.grad(outs, list(mlp.parameters()), grad_outputs=cots)
        torch.cuda.synchronize()
        return partials, w, grads

    partials, w, grads = through_kernels(cot, g_w)
    mma = int(dtype == torch.bfloat16)
    assert [(k.launches - l, k.mma_launches - m) for k, (l, m) in zip(k7, before)] == [(1, mma)] * 2
    with torch.no_grad():
        want, want_w = block_partials_plain(mlp, ro, rd, z, deltas, noise, cfg=cfg,
                                            sample_block=sample_block, emit_weights=emit)
    for k in ("C", "A", "T", "D"):
        assert bool(torch.isfinite(partials[k]).all())
        # D sums w * z with z in [2, 6]: its gate scales with the depth.
        scale = 6.0 if k == "D" else 1.0
        _within_render_gates(partials[k].detach().reshape(n, -1) / scale,
                             want[k].reshape(n, -1) / scale, dtype)
    if emit:
        _within_render_gates(w.detach(), want_w, dtype)
    args = (ro, rd, z, deltas, noise, cot, g_w)
    kw = dict(cfg=cfg, sample_block=sample_block)
    if dtype == torch.bfloat16:
        ref = block_partials_grads_plain(mlp, *args, **kw)
        assert min(_cosine(g, r) for g, r in zip(grads, ref)) > 0.98
        cot, g_w = _partials_cotangents(n, S, cuda_device, seed=46, signed=False)
        g_w = g_w if emit else None
        _, _, grads = through_kernels(cot, g_w)
        ref = block_partials_grads_plain(mlp, ro, rd, z, deltas, noise, cot, g_w, **kw)
        assert min(_cosine(g, r) for g, r in zip(grads, ref)) > 0.98
        _scale_check([n for n, _ in mlp.named_parameters()], grads, ref)
        return
    want64 = [g.float() for g in block_partials_grads_plain(copy.deepcopy(mlp).double(), *args, **kw)]
    plain32 = block_partials_grads_plain(mlp, *args, **kw)
    for g, r, p in zip(grads, want64, plain32):
        tol = 3e-4 * float(r.abs().max())
        slack = float((p - r).abs().max())
        assert float((g - r).abs().max()) <= tol + min(slack, tol) + 1e-8


@pytest.mark.cuda
def test_partials_kernels_replay_bit_identical_on_card(cuda_device):
    """bf16 K7 at the flagship fine shard (blocks of 48) on the tensor
    cores: forward and backward twice on the same inputs, bit-identical."""
    from tinynerf_tpu_torch.kernels.fused_partials import (
        fused_block_partials_bwd,
        fused_block_partials_fwd,
        make_fused_block_partials_fn,
    )

    mlp, cfg, ro, rd, z, deltas, noise = _partials_case(256, 10, 4, True, 96, torch.bfloat16,
                                                        cuda_device, n=256)
    cot, g_w = _partials_cotangents(256, 96, cuda_device)
    fn = make_fused_block_partials_fn(cfg, emit_weights=True, sample_block=48)
    k7 = (fused_block_partials_fwd, fused_block_partials_bwd)
    before = [k.mma_launches for k in k7]
    runs = []
    for _ in range(2):
        partials, w = fn(mlp, ro, rd, z, deltas, noise)
        outs = [partials[k] for k in ("C", "A", "T", "D")] + [w]
        grads = torch.autograd.grad(outs, list(mlp.parameters()),
                                    grad_outputs=[cot[k] for k in ("C", "A", "T", "D")] + [g_w])
        runs.append([o.detach().clone() for o in outs] + [g.clone() for g in grads])
    assert [k.mma_launches - b for k, b in zip(k7, before)] == [2, 2]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_kernels_count_tensor_core_launches_on_card(cuda_device, dtype):
    from tinynerf_tpu_torch.kernels.fused_partials import (
        fused_block_partials_bwd,
        fused_block_partials_fwd,
        make_fused_block_partials_fn,
    )

    mlp, cfg, ro, rd, z, deltas, noise = _partials_case(32, 4, 2, True, 16, dtype, cuda_device,
                                                        n=64)
    k7 = (fused_block_partials_fwd, fused_block_partials_bwd)
    before = [(k.launches, k.mma_launches) for k in k7]
    partials, _ = make_fused_block_partials_fn(cfg, sample_block=8)(mlp, ro, rd, z, deltas, noise)
    torch.autograd.grad(partials["C"].sum(), list(mlp.parameters()))
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert [(k.launches - l, k.mma_launches - m) for k, (l, m) in zip(k7, before)] == [(1, mma)] * 2


@pytest.mark.cuda
def test_partials_kernels_refuse_widths_off_the_tensor_cores_on_card(cuda_device):
    """A bf16 K7 pair at a width the tensor-core walk cannot take routes to
    the CUDA-core walk by configuration (it used to be refused): one
    forward and one backward, none on the tensor cores, the partials
    within the render gates and the gradients (one-signed cotangents)
    within the bf16 gates of the plain versions."""
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain,
        block_partials_plain,
        fused_block_partials_bwd,
        fused_block_partials_fwd,
        make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.ops.volume import global_deltas

    mlp, cfg = _off_tensor_core_width(cuda_device)
    n, S = 128, 16
    ro, rd = _rays(n, 47, cuda_device)
    z_union = _sorted_z(n, 2 * S, 48, cuda_device)
    deltas = global_deltas(z_union, rd)
    z, deltas = z_union[:, S:].contiguous(), deltas[:, S:].contiguous()
    cot, _ = _partials_cotangents(n, S, cuda_device, signed=False)
    k7 = (fused_block_partials_fwd, fused_block_partials_bwd)
    before = [(k.launches, k.mma_launches) for k in k7]
    partials, _ = make_fused_block_partials_fn(cfg, sample_block=8)(mlp, ro, rd, z, deltas)
    outs = [partials[k] for k in ("C", "A", "T", "D")]
    grads = torch.autograd.grad(outs, list(mlp.parameters()),
                                grad_outputs=[cot[k] for k in ("C", "A", "T", "D")])
    torch.cuda.synchronize()
    assert [(k.launches - l, k.mma_launches - m) for k, (l, m) in zip(k7, before)] == [(1, 0)] * 2
    with torch.no_grad():
        want, _ = block_partials_plain(mlp, ro, rd, z, deltas, None, cfg=cfg, sample_block=8)
    for k in ("C", "A", "T", "D"):
        scale = 6.0 if k == "D" else 1.0
        _within_render_gates(partials[k].detach().reshape(n, -1) / scale,
                             want[k].reshape(n, -1) / scale, torch.bfloat16)
    ref = block_partials_grads_plain(mlp, ro, rd, z, deltas, None, cot, None, cfg=cfg,
                                     sample_block=8)
    assert min(_cosine(g, r) for g, r in zip(grads, ref)) > 0.98
    _scale_check([n for n, _ in mlp.named_parameters()], grads, ref)


@pytest.mark.cuda
def test_partials_two_shards_equal_the_streamed_pass_on_card(cuda_device):
    """Two K7 shards of one union, combined, against K6's loss and
    gradients on the whole union: the same per-point code, so only the
    order of sums differs (K6 against K4's gates, 1e-5 of each leaf's
    max)."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
    from tinynerf_tpu_torch.kernels.fused_partials import make_fused_block_partials_fn
    from tinynerf_tpu_torch.ops.volume import combine_block_partials, global_deltas

    mlp, cfg = _nerf_case(128, 10, 4, True, torch.float32, cuda_device)
    n = 256
    ro, rd = _rays(n, 32, cuda_device)
    target = torch.from_numpy(np.random.RandomState(33).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 192, 34, cuda_device)
    deltas = global_deltas(z, rd)
    fn = make_fused_block_partials_fn(cfg, sample_block=48)
    parts = [fn(mlp, ro, rd, z[:, s:s + 96].contiguous(), deltas[:, s:s + 96].contiguous())[0]
             for s in (0, 96)]
    comp, _, _ = combine_block_partials({k: torch.stack([p[k] for p in parts]) for k in parts[0]})
    loss = torch.mean((comp - target) ** 2)
    grads = torch.autograd.grad(loss, list(mlp.parameters()))
    l6, g6 = fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, cfg=cfg, sample_block=48)
    assert abs(float(loss) - float(l6)) <= 1e-6 * float(l6)
    for a, b in zip(grads, g6):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-9


# F3: widths whose rgb_hidden does not divide hidden's thread mapping
# (hidden 48 with the default rgb_hidden 64) and widths that are not
# multiples of 8 (36 / 20, zero-padded to 40 / 24 by the wrappers).
F3_WIDTHS = [(48, 64), (36, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rgb_hidden", F3_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_kernels_take_any_width_on_card(cuda_device, hidden, rgb_hidden, dtype):
    """K3 (weights out), K5, K4, K6 and the K7 pair at the F3 widths (L 10,
    L_dir 4, depth 8, skip 4) on the CUDA cores: one launch each, none on
    the tensor cores, within the render gates and the NeRF pass gates of
    their plain versions (K7 on one-signed cotangents)."""
    import copy

    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays,
        fused_nerf_render_rays_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
        fused_nerf_render_rays_streamed,
        fused_nerf_render_rays_streamed_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
        uses_tensor_cores,
    )
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain,
        block_partials_plain,
        fused_block_partials_bwd,
        fused_block_partials_fwd,
        make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.ops.volume import global_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=dtype)
    assert not uses_tensor_cores(cfg)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(3), device=cuda_device)
    names = [n for n, _ in mlp.named_parameters()]
    n = 300
    ro, rd = _rays(n, 50, cuda_device)
    target = torch.from_numpy(np.random.RandomState(51).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 48, 52, cuda_device)
    kernels = (fused_nerf_render_rays, fused_nerf_render_rays_streamed, fused_nerf_pass_grads,
               fused_nerf_pass_grads_streamed, fused_block_partials_fwd, fused_block_partials_bwd)
    before = [(k.launches, k.mma_launches) for k in kernels]

    with torch.no_grad():
        got, got_w = fused_nerf_render_rays(mlp, ro, rd, n_samples=64, cfg=cfg, return_weights=True)
        want, want_w = fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=64, cfg=cfg,
                                                    return_weights=True)
        got5 = fused_nerf_render_rays_streamed(mlp, ro, rd, z, cfg=cfg, sample_block=16)
        want5 = fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z, cfg=cfg, sample_block=16)
    for a, b in ((got, want), (got_w, want_w), (got5, want5)):
        assert bool(torch.isfinite(a).all())
        _within_render_gates(a, b, dtype)

    kw4 = dict(n_samples=48, randomized=False, cfg=cfg)
    loss, grads = fused_nerf_pass_grads(mlp, ro, rd, target, 0, z, **kw4)
    ref = _plain(fused_nerf_pass_grads_plain, mlp, ro, rd, target, 0, z, dtype=dtype, **kw4)
    _leaf_check(loss, grads, ref, dtype, names=names)
    kw6 = dict(cfg=cfg, sample_block=8)
    loss, grads = fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, **kw6)
    ref = _plain(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z, dtype=dtype, **kw6)
    _leaf_check(loss, grads, ref, dtype, names=names)

    deltas = global_deltas(z, rd)
    z_sh, d_sh = z[:, 24:].contiguous(), deltas[:, 24:].contiguous()
    cot, _ = _partials_cotangents(n, 24, cuda_device, seed=53, signed=False)
    fn = make_fused_block_partials_fn(cfg, sample_block=8)
    partials, _ = fn(mlp, ro, rd, z_sh, d_sh)
    keys = ("C", "A", "T", "D")
    grads = torch.autograd.grad([partials[k] for k in keys], list(mlp.parameters()),
                                grad_outputs=[cot[k] for k in keys])
    torch.cuda.synchronize()
    with torch.no_grad():
        want7, _ = block_partials_plain(mlp, ro, rd, z_sh, d_sh, None, cfg=cfg, sample_block=8)
    for k in keys:
        scale = 6.0 if k == "D" else 1.0
        _within_render_gates(partials[k].detach().reshape(n, -1) / scale,
                             want7[k].reshape(n, -1) / scale, dtype)
    args = (ro, rd, z_sh, d_sh, None, cot, None)
    if dtype == torch.bfloat16:
        ref = block_partials_grads_plain(mlp, *args, cfg=cfg, sample_block=8)
        assert min(_cosine(g, r) for g, r in zip(grads, ref)) > 0.98
        _scale_check(names, grads, ref)
    else:
        want64 = [g.float() for g in block_partials_grads_plain(
            copy.deepcopy(mlp).double(), *args, cfg=cfg, sample_block=8)]
        plain32 = block_partials_grads_plain(mlp, *args, cfg=cfg, sample_block=8)
        for g, r, p in zip(grads, want64, plain32):
            tol = 3e-4 * float(r.abs().max())
            assert float((g - r).abs().max()) <= tol + min(float((p - r).abs().max()), tol) + 1e-8
    moved = [(k.launches - a, k.mma_launches - b) for k, (a, b) in zip(kernels, before)]
    assert moved == [(1, 0)] * len(kernels)


@pytest.mark.cuda
def test_nerf_kernels_refuse_unpadded_widths_in_c_on_card(cuda_device):
    """The C entries take the CUDA-core route only at hidden and rgb_hidden
    multiples of 8 (the wrappers pad): hidden 36 handed over as it is comes
    back as cudaErrorInvalidValue, nothing launched; so does rgb_hidden 0."""
    from tinynerf_tpu_torch.kernels.fused_nerf import _lib

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    args = (None,) * 7 + (128, 1, 64, 10, 4, 1)
    tail = (2.0, 6.0, 0, 0, None, 1, cuda_device.index, stream)
    err = _lib().tinynerf_fused_nerf(*args, 36, 8, 4, 20, *tail)
    assert err == 1  # cudaErrorInvalidValue
    assert _lib().tinynerf_fused_nerf(*args, 40, 8, 4, 0, *tail) == 1  # rgb_hidden 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_kernels_on_grid_proposed_depths_on_card(cuda_device, dtype):
    """The occupancy proposal's depths (ops/occupancy.py: a 32^3 grid of
    the MLP over the rays' box, 96 samples over 64 segments, jittered as
    in training) through K6 and the deterministic ones through K5, in
    blocks of pick_sample_block(96), against their plain versions: the
    NeRF pass gates and the render gates; bf16 at hidden 128 on the
    tensor cores (one .mma_launches each), f32 on the CUDA cores."""
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_pass_grads_streamed,
        fused_nerf_pass_grads_streamed_plain,
        fused_nerf_render_rays_streamed,
        fused_nerf_render_rays_streamed_plain,
        pick_sample_block,
    )
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.ops.occupancy import aabb_from_rays, density_grid, occupancy_samples

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(hidden=128, compute_dtype=dtype)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(60), device=cuda_device)
    with torch.no_grad():
        mlp.sigma.bias.add_(1.0)  # opacity along the rays
    n = 300
    ro, rd = _rays(n, 61, cuda_device)
    target = torch.from_numpy(np.random.RandomState(62).rand(n, 3).astype(np.float32)).to(cuda_device)
    box = aabb_from_rays(ro, rd, 2.0, 6.0)
    grid = density_grid(mlp, cfg, resolution=32, aabb=box,
                        generator=torch.Generator(device=cuda_device).manual_seed(63))
    kw = dict(n_segments=64, aabb=box)
    z_train = occupancy_samples(grid, ro, rd, 2.0, 6.0, 96, randomized=True,
                                generator=torch.Generator(device=cuda_device).manual_seed(64), **kw)
    z_render = occupancy_samples(grid, ro, rd, 2.0, 6.0, 96, **kw)
    sb = pick_sample_block(96)
    mma = int(dtype == torch.bfloat16)
    k5, k6 = fused_nerf_render_rays_streamed, fused_nerf_pass_grads_streamed
    before = [(k.launches, k.mma_launches) for k in (k5, k6)]
    with torch.no_grad():
        got = k5(mlp, ro, rd, z_render, cfg=cfg, sample_block=sb)
        want = fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z_render, cfg=cfg, sample_block=sb)
    _within_render_gates(got, want, dtype)
    loss, grads = k6(mlp, ro, rd, target, z_train, cfg=cfg, sample_block=sb)
    torch.cuda.synchronize()
    ref = _plain(fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z_train, dtype=dtype,
                 cfg=cfg, sample_block=sb)
    _leaf_check(loss, grads, ref, dtype, names=[n for n, _ in mlp.named_parameters()])
    assert [(k.launches - a, k.mma_launches - b) for k, (a, b) in zip((k5, k6), before)] == [(1, mma)] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_family_on_card_matches_the_cpu(cuda_device, dtype):
    """The grid family (models/grid_nerf.py, eager torch, no kernel) on the
    card against the CPU at the same weights, 4096 points over the box and
    beyond it, two dense levels and one hashed: f32 rgb and sigma within
    1e-5 and every leaf's gradient within 1e-4 of its max; bf16 rgb under
    the render gates. The tables' gradient (the gather's backward) is
    bit-identical across two backward passes on the card."""
    from tinynerf_tpu_torch.models.grid_nerf import GridNeRF, GridNeRFConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GridNeRFConfig(n_levels=3, base_res=4, max_res=16, table_size=1 << 10, hidden=16,
                         geo_features=7, num_freqs_dir=2, aabb=(-1.0,) * 3 + (1.0,) * 3,
                         compute_dtype=dtype)
    cpu = GridNeRF(cfg, generator=torch.Generator().manual_seed(70))
    with torch.no_grad():
        for t in cpu.tables.values():
            t.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(71))
    card = GridNeRF(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(72)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (4096, 3)).astype(np.float32))
    d = torch.from_numpy(rng.randn(4096, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    grads = {}
    runs = (("cpu", cpu, "cpu"), ("card", card, cuda_device), ("again", card, cuda_device))
    for name, model, dev in runs:
        model.zero_grad()
        with torch.enable_grad():
            rgb, sigma = model(pts.to(dev), d.to(dev))
            (rgb.square().mean() + sigma.mean()).backward()
        grads[name] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        grads[name + " out"] = (rgb.detach().cpu(), sigma.detach().cpu())
    (rc, sc), (rg, sg) = grads["cpu out"], grads["card out"]
    if dtype == torch.float32:
        assert float((rc - rg).abs().max()) < 1e-5 and float((sc - sg).abs().max()) < 1e-5
        for n, g in grads["cpu"].items():
            assert float((grads["card"][n] - g).abs().max()) <= 1e-4 * float(g.abs().max()), n
    else:
        _within_render_gates(rg, rc, dtype)
    for n in grads["card"]:
        if n.startswith("tables."):
            assert torch.equal(grads["card"][n], grads["again"][n]), n


# The scene axis of K2, K4 and K6 (multi-scene training: one launch trains
# every scene of a step).

SCENE_SEEDS = (5, 9, 13)
# The NeRF scenes' model seeds: each leaves the flagship's density alive at
# init on these rays. A dead one gives all-zero leaves, which the bf16
# cosine gate cannot read (seed 9: 44 of the plain K6 reference's leaves
# are zero); _live_leaves checks every reference leaf.
NERF_SCENE_SEEDS = (5, 8, 17)


def _live_leaves(ref, names):
    """Each leaf of a plain reference (loss, grads, slack) holds a non-zero
    value, so that the gates compare something."""
    for g, name in zip(ref[1], names):
        assert float(g.abs().max()) > 0, f"the reference's {name} is all zeros: a dead scene"


def _stacked(make, seeds, device):
    from tinynerf_tpu_torch.models.stacked import stack_models

    return stack_models([make(torch.Generator().manual_seed(s), device) for s in seeds])


def _scene_rays(K, n, seed, device):
    pairs = [_rays(n, seed + k, device) for k in range(K)]
    target = torch.from_numpy(np.random.RandomState(seed).rand(K, n, 3).astype(np.float32))
    return (torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]),
            target.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_scene_axis_bit_identical_to_one_scene_launches_on_card(cuda_device, dtype, noise):
    """One batched K2 launch over 3 stacked TinyNeRFs (jittered in the
    kernel, 256 rays each, seeds 5, 9, 13): each scene's loss and every
    gradient leaf bit-identical to a one-scene launch with its seed (the
    Philox draws keyed by scene-local rays, the blocks a scene independent
    of K); one launch counted, one scene launch; and against the plain
    version scene by scene under the K2 gates on the grid depths."""
    from tinynerf_tpu_torch.kernels import fused_train as k2
    from tinynerf_tpu_torch.models.stacked import scene_module

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=128, compute_dtype=dtype)
    model = _stacked(lambda g, d: TinyNeRF(cfg, generator=g, device=d), SCENE_SEEDS, cuda_device)
    K, n = len(SCENE_SEEDS), 256
    ro, rd, target = _scene_rays(K, n, 60, cuda_device)
    sigma_noise = None
    if noise:
        g = torch.Generator(device=cuda_device).manual_seed(4)
        sigma_noise = torch.randn(K, n, 64, generator=g, device=cuda_device)
    seeds = torch.tensor(SCENE_SEEDS, dtype=torch.int32, device=cuda_device)
    before = (k2.fused_loss_grads.launches, k2.fused_loss_grads.mma_launches,
              k2.fused_loss_grads.scene_launches)
    loss, grads = k2.fused_loss_grads_scenes(model, ro, rd, target, seeds, sigma_noise=sigma_noise)
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert (k2.fused_loss_grads.launches - before[0], k2.fused_loss_grads.mma_launches - before[1],
            k2.fused_loss_grads.scene_launches - before[2]) == (1, mma, 1)
    assert loss.shape == (K,) and all(g.shape == p.shape for g, p in zip(grads, model.parameters()))
    for k, seed in enumerate(SCENE_SEEDS):
        one = scene_module(model, k)
        l1, g1 = k2.fused_loss_grads(one, ro[k], rd[k], target[k], seed,
                                     sigma_noise=None if noise is False else sigma_noise[k])
        assert float(loss[k]) == float(l1)
        assert all(torch.equal(a[k], b) for a, b in zip(grads, g1))
    kw = dict(randomized=False, sigma_noise=sigma_noise)
    loss, grads = k2.fused_loss_grads_scenes(model, ro, rd, target, seeds, **kw)
    want_loss, want = k2.fused_loss_grads_scenes_plain(model, ro, rd, target, seeds, **kw)
    names = [n for n, _ in model.named_parameters()]
    for k in range(K):
        rel = abs(float(loss[k]) - float(want_loss[k])) / float(want_loss[k])
        if dtype == torch.float32:
            assert rel < 1e-5
            for g, w in zip(grads, want):
                assert float((g[k] - w[k]).abs().max()) <= 2e-4 * float(w[k].abs().max()) + 1e-8
        else:
            assert rel < 1e-3
            assert min(_cosine(g[k], w[k]) for g, w in zip(grads, want)) > 0.98
            _scale_check(names, [g[k] for g in grads], [w[k] for w in want])


def _nerf_stack(hidden, dtype, device):
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP

    depth, skip_at, rgb_hidden = (8, 4, 64) if hidden == 256 else (3, 2, 32)
    cfg = NeRFConfig(num_freqs=10, num_freqs_dir=4, hidden=hidden, depth=depth, skip_at=skip_at,
                     rgb_hidden=rgb_hidden, compute_dtype=dtype)
    return _stacked(lambda g, d: NeRFMLP(cfg, generator=g, device=d), NERF_SCENE_SEEDS,
                    device), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_scene_axis_bit_identical_to_one_scene_launches_on_card(cuda_device, hidden, dtype):
    """One batched K4 launch over 3 stacked NeRF MLPs (NERF_SCENE_SEEDS), the coarse pass
    jittered in the kernel (300 rays: padding, S=64, weights and depths
    out), then the fine pass on given sorted depths (S=96, sigma-noise):
    every scene's loss, gradient leaves, weights and depths bit-identical
    to a one-scene launch with its seed; scene k's depths equal K2's
    jitter_probe with seed k; one launch and one scene launch counted per
    call; the plain version scene by scene under the NeRF pass gates."""
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels.fused_train import jitter_probe
    from tinynerf_tpu_torch.models.stacked import scene_module

    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg = _nerf_stack(hidden, dtype, cuda_device)
    K, n = len(SCENE_SEEDS), 300
    ro, rd, target = _scene_rays(K, n, 70, cuda_device)
    seeds = torch.tensor(SCENE_SEEDS, dtype=torch.int32, device=cuda_device)
    f = k4.fused_nerf_pass_grads
    before = (f.launches, f.mma_launches, f.scene_launches)
    loss, grads, w, z = k4.fused_nerf_pass_grads_scenes(model, ro, rd, target, seeds, n_samples=64,
                                                        emit_sampling=True, cfg=cfg)
    torch.cuda.synchronize()
    mma = int(dtype == torch.bfloat16)
    assert (f.launches - before[0], f.mma_launches - before[1],
            f.scene_launches - before[2]) == (1, mma, 1)
    assert w.shape == z.shape == (K, n, 64)
    for k, seed in enumerate(SCENE_SEEDS):
        l1, g1, w1, z1 = f(scene_module(model, k), ro[k], rd[k], target[k], seed, n_samples=64,
                           emit_sampling=True, cfg=cfg)
        assert float(loss[k]) == float(l1) and torch.equal(w[k], w1) and torch.equal(z[k], z1)
        assert all(torch.equal(a[k], b) for a, b in zip(grads, g1))
        assert torch.equal(z[k], jitter_probe(seed, n, 64, 2.0, 6.0, tile=1, device=cuda_device))
    zf = torch.stack([_sorted_z(n, 96, 71 + k, cuda_device) for k in range(K)])
    g = torch.Generator(device=cuda_device).manual_seed(8)
    noise = torch.randn(K, n, 96, generator=g, device=cuda_device)
    loss, grads = k4.fused_nerf_pass_grads_scenes(model, ro, rd, target, seeds, zf,
                                                  sigma_noise=noise, randomized=False, cfg=cfg)
    names = [nm for nm, _ in model.named_parameters()]
    for k, seed in enumerate(SCENE_SEEDS):
        one = scene_module(model, k)
        kw = dict(sigma_noise=noise[k], randomized=False, cfg=cfg)
        l1, g1 = f(one, ro[k], rd[k], target[k], seed, zf[k], **kw)
        assert float(loss[k]) == float(l1) and all(torch.equal(a[k], b) for a, b in zip(grads, g1))
        ref = _plain(k4.fused_nerf_pass_grads_plain, one, ro[k], rd[k], target[k], seed, zf[k],
                     dtype=dtype, **kw)
        _live_leaves(ref, names)
        _leaf_check(loss[k], [gr[k] for gr in grads], ref, dtype, names=names)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_scene_axis_bit_identical_to_one_scene_launches_on_card(cuda_device, dtype):
    """One batched K6 launch over 3 stacked flagship MLPs on given sorted
    unions (300 rays x 192, block 64): every scene's loss and gradient
    leaves bit-identical to a one-scene launch; one launch and one scene
    launch counted; the plain version scene by scene under the pass
    gates."""
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6
    from tinynerf_tpu_torch.models.stacked import scene_module

    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg = _nerf_stack(256, dtype, cuda_device)
    K, n = len(SCENE_SEEDS), 300
    ro, rd, target = _scene_rays(K, n, 80, cuda_device)
    z = torch.stack([_sorted_z(n, 192, 81 + k, cuda_device) for k in range(K)])
    f = k6.fused_nerf_pass_grads_streamed
    before = (f.launches, f.mma_launches, f.scene_launches)
    loss, grads = k6.fused_nerf_pass_grads_streamed_scenes(model, ro, rd, target, z, cfg=cfg)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.mma_launches - before[1],
            f.scene_launches - before[2]) == (1, int(dtype == torch.bfloat16), 1)
    names = [nm for nm, _ in model.named_parameters()]
    for k in range(K):
        one = scene_module(model, k)
        l1, g1 = f(one, ro[k], rd[k], target[k], z[k], cfg=cfg)
        assert float(loss[k]) == float(l1) and all(torch.equal(a[k], b) for a, b in zip(grads, g1))
        ref = _plain(k6.fused_nerf_pass_grads_streamed_plain, one, ro[k], rd[k], target[k], z[k],
                     dtype=dtype, cfg=cfg)
        _live_leaves(ref, names)
        _leaf_check(loss[k], [gr[k] for gr in grads], ref, dtype, names=names)


@pytest.mark.cuda
def test_scene_axis_refuses_wrong_counts_and_strides_on_card(cuda_device):
    """The C entries of K2 and K4/K6 take a scene count in [1, 65535] and
    each weight buffer's scene stride as one model's packed size rounded
    up to a multiple of 4 (16-byte aligned slabs): anything else comes back
    as cudaErrorInvalidValue (1) before a launch."""
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels import fused_train as k2
    from tinynerf_tpu_torch.kernels.fused_nerf import pack_nerf_weights
    from tinynerf_tpu_torch.kernels.fused_render import pack_tiny_weights
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    dev = cuda_device.index
    cfg = TinyNeRFConfig(in_dim=encoding_dim(4), hidden=32, compute_dtype=torch.float32)
    n_grad = pack_tiny_weights(TinyNeRF(cfg), cfg)[0].numel()
    row, bwd = k2.partial_row(n_grad), 3 * 32 * 32
    dummy = torch.zeros(1, device=cuda_device).data_ptr()

    def k2_err(n_scenes, fwd, bwd_stride):
        return k2._lib().tinynerf_fused_train(
            None, None, None, None, None, None, dummy, None, None, None, None, 64, 4, 16, 4, 32,
            4, 2, 2.0, 0.1, 0.01, 0, 1, 0, 16, n_grad, row, n_scenes, fwd, bwd_stride, 0, 0, None,
            dev, stream)

    for args in ((2, n_grad + 4, bwd), (2, n_grad, bwd + 1), (0, n_grad, bwd), (70000, n_grad, bwd)):
        assert k2_err(*args) == 1, args
    ncfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16,
                      compute_dtype=torch.float32)
    n_grad = pack_nerf_weights(NeRFMLP(ncfg), ncfg).numel()
    slab, want_bwd = -(-n_grad // 4) * 4, 2 * 32 * 32 + 16 * 32
    geom = (4, 2, 1, 32, 3, 2, 16)
    # n_grad itself (4727) is no slab: the scenes' weights start 16-byte aligned.
    for n_scenes, fwd, bwd_stride in ((2, n_grad, want_bwd), (2, slab + 4, want_bwd),
                                      (2, slab, want_bwd - 4), (0, slab, want_bwd),
                                      (70000, slab, want_bwd)):
        err = k4._lib().tinynerf_fused_nerf_train(
            *(None,) * 8, dummy, None, None, None, None, None, None, None, 128, 128, 8, 16, *geom,
            2.0, 0.1, 0.01, 0, 1, 0, 16, n_grad, n_scenes, fwd, bwd_stride, 0, 0, None, dev,
            stream)
        assert err == 1, (n_scenes, fwd, bwd_stride)
        err = k4._lib().tinynerf_fused_nerf_train_streamed(
            *(None,) * 7, dummy, None, None, None, None, None, 128, 128, 8, 16, 8, *geom, 0.01, 1,
            0, 16, n_grad, n_scenes, fwd, bwd_stride, 0, 0, None, dev, stream)
        assert err == 1, (n_scenes, fwd, bwd_stride)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tinynerf", "nerf", "flagship"])
def test_fused_multiscene_block_equals_one_scene_blocks_on_card(cuda_device, kind):
    """A fused K-scene block (make_fused_grad_fn_scenes or
    make_fused_nerf_grad_fn_scenes: one batched K2, or K4 coarse and K4
    or K6 fine, a step) of 4 steps with sigma-noise on equals 3 fused
    one-scene blocks (make_fused_grad_fn, make_fused_nerf_grad_fn) on
    each scene's seed and data, bf16 on the tensor cores: every scene's
    losses and parameters within 1e-6 (tests/test_multiscene.py:54-88's
    tolerance), and one batched launch a pass a step."""
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels import fused_train as k2
    from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig
    from tinynerf_tpu_torch.multiscene import (
        init_multiscene_state, make_multiscene_train_block, scene_params, scene_seed)
    from tinynerf_tpu_torch.training import TrainSettings, init_train_state, make_train_block

    torch.backends.cuda.matmul.allow_tf32 = False
    K, steps, bf16 = 3, 4, torch.bfloat16
    if kind == "tinynerf":
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=128, compute_dtype=bf16)
        s = TrainSettings(n_rand=256, n_samples=64, model_cfg=cfg, sigma_noise_std=0.3)
        init_fn = None
        gf, gf1 = k2.make_fused_grad_fn_scenes(s), k2.make_fused_grad_fn(s)
        counters, per_step = [k2.fused_loss_grads], [1]
    else:
        hidden, n_fine, block = (64, 64, None) if kind == "nerf" else (256, 128, 64)
        cfg = NeRFConfig(hidden=hidden, rgb_hidden=hidden // 2, compute_dtype=bf16)
        s = TrainSettings(n_rand=256, n_samples=64, sigma_noise_std=0.3)
        init_fn = lambda g, d: NeRF(cfg, generator=g, device=d)  # noqa: E731
        gf = k4.make_fused_nerf_grad_fn_scenes(s, cfg, n_fine=n_fine, sample_block=block)
        gf1 = k4.make_fused_nerf_grad_fn(s, cfg, n_fine=n_fine, sample_block=block)
        counters = [k4.fused_nerf_pass_grads, k6.fused_nerf_pass_grads_streamed]
        per_step = [2, 0] if block is None else [1, 1]
    rng = np.random.RandomState(3)
    ro = (rng.randn(K, 2, 1024, 3) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = rng.randn(K, 2, 1024, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    px = rng.rand(K, 2, 1024, 3).astype(np.float32)
    data = [torch.from_numpy(a).to(cuda_device) for a in (ro, rd, px)]
    model, opt = init_multiscene_state(0, K, s, device=cuda_device, init_fn=init_fn)
    before = [(c.launches, c.scene_launches) for c in counters]
    m = make_multiscene_train_block(s, steps, K, grad_fn=gf)(model, opt, 7, 0, *data)
    torch.cuda.synchronize()
    assert [(c.launches - b[0], c.scene_launches - b[1]) for c, b in zip(counters, before)] == [
        (n * steps, n * steps) for n in per_step]
    single = make_train_block(s, steps, grad_fn=gf1)
    for k in range(K):
        m1, o1 = init_train_state(torch.Generator().manual_seed(scene_seed(0, k)), s,
                                  device=cuda_device, init_fn=init_fn)
        r = single(m1, o1, scene_seed(7, k), 0, data[0][k], data[1][k], data[2][k])
        assert torch.allclose(m["loss"][:, k], r["loss"], rtol=0, atol=1e-6), k
        for a, b in zip(scene_params(model, k).parameters(), m1.parameters()):
            assert torch.allclose(a, b, rtol=0, atol=1e-6), k


# Every TinyNeRF shape the JAX kernels take (F4, F5): (hidden, depth,
# skip_at, S, n_rays). S=20: tiles of 3 rays, 250 rays padded; hidden 36:
# padded to 40; the rest pass 227 KB of shared memory: the spill route.
K2_DOMAIN = [(128, 4, 2, 20, 250), (36, 4, 2, 64, 256), (168, 4, 2, 64, 256),
             (256, 4, 2, 64, 256), (128, 6, 3, 64, 256), (128, 4, 2, 96, 128),
             (128, 4, 2, 128, 128), (256, 8, 4, 64, 256)]


def _tiny_domain_case(hidden, depth, skip_at, dtype, device, n_rays, seed=3):
    cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=hidden, depth=depth, skip_at=skip_at,
                         compute_dtype=dtype)
    model = TinyNeRF(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    ro, rd = _rays(n_rays, seed, device)
    target = torch.from_numpy(np.random.RandomState(seed).rand(n_rays, 3).astype(np.float32))
    return model, cfg, ro, rd, target.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,depth,skip_at,S,n_rays", K2_DOMAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_kernel_takes_every_tiny_shape_on_card(cuda_device, hidden, depth, skip_at, S,
                                                     n_rays, dtype):
    """K2 at every F4 shape: one launch, on the memory and products routes
    its rules give (every shape past 227 KB on the spill route), under the
    K2 gates against its plain version; none refused, none on the plain
    version."""
    import dataclasses

    from tinynerf_tpu_torch.kernels import fused_train as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg, ro, rd, target = _tiny_domain_case(hidden, depth, skip_at, dtype, cuda_device,
                                                   n_rays)
    kw = dict(n_samples=S, randomized=False)
    cfg8 = dataclasses.replace(cfg, hidden=-(-hidden // 8) * 8)
    spill = not k2.k2_fits_shared_memory(cfg, S)
    assert spill is (hidden not in (36,) and S != 20)
    f = k2.fused_loss_grads
    before = (f.launches, f.mma_launches, f.spill_launches)
    loss, grads = f(model, ro, rd, target, 0, **kw)
    torch.cuda.synchronize()
    assert (f.launches - before[0], f.mma_launches - before[1], f.spill_launches - before[2]) == (
        1, int(k2.k2_uses_tensor_cores(cfg8, S)), int(spill))
    want_loss, want = k2.fused_loss_grads_plain(model, ro, rd, target, 0, **kw)
    rel = abs(float(loss) - float(want_loss)) / float(want_loss)
    assert all(g.shape == p.shape for g, p in zip(grads, model.parameters()))
    if dtype == torch.float32:
        assert rel < 1e-5
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= 2e-4 * float(w.abs().max()) + 1e-8
    else:
        assert rel < 1e-3
        assert min(_cosine(g, w) for g, w in zip(grads, want)) > 0.98
        _scale_check([n for n, _ in model.named_parameters()], grads, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(128, torch.float32), (128, torch.bfloat16),
                                          (36, torch.bfloat16)])
def test_spill_route_is_bit_identical_to_the_shared_route_on_card(cuda_device, hidden, dtype):
    """The spill route forced at a shape that fits shared memory (the
    recipe's; hidden 36) gives the shared route's loss and gradients bit
    for bit, jittered and with sigma-noise: the same arithmetic in the same
    order, the activations in a device workspace."""
    from tinynerf_tpu_torch.kernels.fused_train import fused_loss_grads

    model, _, ro, rd, target = _tiny_domain_case(hidden, 4, 2, dtype, cuda_device, 512)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    noise = torch.randn(512, 64, generator=g, device=cuda_device)
    before = fused_loss_grads.spill_launches
    (l0, g0), (l1, g1) = [fused_loss_grads(model, ro, rd, target, 11, sigma_noise=noise,
                                           spill=spill) for spill in (False, True)]
    assert fused_loss_grads.spill_launches == before + 1
    assert float(l0) == float(l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))


# (hidden, depth, skip_at, S, n_rays): hidden 36 (padded), 264 (past 512
# threads: rounds), S=192 at hidden 256 and S=512 (past 227 KB: segments).
K1_DOMAIN = [(36, 4, 2, 64, 1001), (264, 4, 2, 64, 1001), (256, 4, 2, 192, 300),
             (128, 4, 2, 512, 300), (256, 8, 4, 64, 1001)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,depth,skip_at,S,n_rays", K1_DOMAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_render_kernel_takes_every_tiny_shape_on_card(cuda_device, hidden, depth, skip_at, S,
                                                      n_rays, dtype):
    """K1 at the F4b and F4d shapes and the full width: one launch on the
    route k1_shape gives (the general kernel past 512 threads or 227 KB),
    under the render gates against its plain version."""
    import dataclasses

    from tinynerf_tpu_torch.kernels.fused_render import k1_shape

    torch.backends.cuda.matmul.allow_tf32 = False
    model, cfg, ro, rd, _ = _tiny_domain_case(hidden, depth, skip_at, dtype, cuda_device, n_rays)
    mma, general = k1_shape(dataclasses.replace(cfg, hidden=-(-hidden // 8) * 8), S)[:2]
    assert general is (hidden == 264 or S > 128)
    f = fused_render_rays
    before = (f.launches, f.mma_launches, f.general_launches)
    with torch.no_grad():
        got = f(model, ro, rd, n_samples=S)
        torch.cuda.synchronize()
        want = fused_render_rays_plain(model, ro, rd, n_samples=S)
    assert (f.launches - before[0], f.mma_launches - before[1],
            f.general_launches - before[2]) == (1, int(mma), int(general))
    assert got.shape == (n_rays, 3) and bool(torch.isfinite(got).all())
    e = (got - want).abs().max(dim=1).values
    if dtype == torch.float32:
        assert float(torch.quantile(e, 0.999)) < 5e-4
    else:
        assert float(torch.quantile(e, 0.999)) < 3e-2 and float(e.mean()) < 1e-3
    assert float((e > 3e-2).float().mean()) < 2.5e-3


@pytest.mark.cuda
def test_scene_axis_takes_widths_off_8_on_card(cuda_device):
    """K2 (hidden 36, 20 samples: 250 rays padded to whole tiles; and the
    8 x 256 trunk on the spill route), K4 and K6 (hidden 36, rgb_hidden
    20) over 3 stacked scenes: each scene bit-identical to its one-scene
    launch."""
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k6
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels import fused_train as k2
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.models.stacked import scene_module

    bf16 = torch.bfloat16
    seeds = torch.tensor(SCENE_SEEDS, dtype=torch.int32, device=cuda_device)
    K = len(SCENE_SEEDS)
    for hidden, depth, skip_at, S in ((36, 4, 2, 20), (256, 8, 4, 64)):
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=hidden, depth=depth, skip_at=skip_at,
                             compute_dtype=bf16)
        model = _stacked(lambda g, d: TinyNeRF(cfg, generator=g, device=d), SCENE_SEEDS,
                         cuda_device)
        ro, rd, target = _scene_rays(K, 250, 61, cuda_device)
        loss, grads = k2.fused_loss_grads_scenes(model, ro, rd, target, seeds, n_samples=S)
        for k in range(K):
            l1, g1 = k2.fused_loss_grads(scene_module(model, k), ro[k], rd[k], target[k],
                                         seeds[k:k + 1], n_samples=S)
            assert float(loss[k]) == float(l1)
            assert all(torch.equal(a[k], b) for a, b in zip(grads, g1))
    ncfg = NeRFConfig(num_freqs=10, num_freqs_dir=4, hidden=36, depth=3, skip_at=2,
                      rgb_hidden=20, compute_dtype=bf16)
    model = _stacked(lambda g, d: NeRFMLP(ncfg, generator=g, device=d), SCENE_SEEDS, cuda_device)
    ro, rd, target = _scene_rays(K, 300, 62, cuda_device)
    loss, grads, w, z = k4.fused_nerf_pass_grads_scenes(model, ro, rd, target, seeds,
                                                        emit_sampling=True, cfg=ncfg)
    zu = torch.sort(torch.cat([z, z + 0.01], dim=-1), dim=-1).values.contiguous()
    loss6, grads6 = k6.fused_nerf_pass_grads_streamed_scenes(model, ro, rd, target, zu, cfg=ncfg,
                                                            sample_block=64)
    for k in range(K):
        one = scene_module(model, k)
        l1, g1, w1, z1 = k4.fused_nerf_pass_grads(one, ro[k], rd[k], target[k], seeds[k:k + 1],
                                                  emit_sampling=True, cfg=ncfg)
        assert float(loss[k]) == float(l1) and torch.equal(w[k], w1) and torch.equal(z[k], z1)
        assert all(torch.equal(a[k], b) for a, b in zip(grads, g1))
        l6, g6 = k6.fused_nerf_pass_grads_streamed(one, ro[k], rd[k], target[k], zu[k], cfg=ncfg,
                                                   sample_block=64)
        assert float(loss6[k]) == float(l6)
        assert all(torch.equal(a[k], b) for a, b in zip(grads6, g6))


@pytest.mark.cuda
def test_k2_refuses_a_memory_route_that_cannot_run_on_card(cuda_device):
    """K2's C entry refuses, with cudaErrorInvalidValue (1) before any
    launch, a shared-memory launch past 227 KB (hidden 168), a spill
    launch without its workspace, a workspace without the spill route, and
    a CUDA-core width off multiples of 8 (the wrapper pads)."""
    from tinynerf_tpu_torch.kernels import fused_train as k2
    from tinynerf_tpu_torch.kernels.fused_render import pack_tiny_weights

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    dummy = torch.zeros(1, device=cuda_device).data_ptr()
    for hidden, spill, ws in ((168, 0, None), (128, 1, None), (128, 0, dummy), (36, 0, None)):
        cfg = TinyNeRFConfig(in_dim=encoding_dim(10), hidden=hidden, compute_dtype=torch.float32)
        n_grad = pack_tiny_weights(TinyNeRF(cfg), cfg)[0].numel()
        err = k2._lib().tinynerf_fused_train(
            None, None, None, None, None, None, dummy, None, None, None, None, 128, 1, 64, 10,
            hidden, 4, 2, 2.0, 0.1, 0.01, 0, 1, 0, 16, n_grad, k2.partial_row(n_grad), 1, 0, 0, 0,
            spill, ws, cuda_device.index, stream)
        assert err == 1, (hidden, spill, ws)


# F6 and F7: every NeRF width and sample count the JAX kernels take.
# (tag, hidden, rgb_hidden, S, union, block, seed): K3 renders S linspace
# samples (weights out), K4 trains S jittered samples, K5 renders the union
# in blocks, K6 trains it in blocks, the K7 pair runs it as one shard in
# blocks. The blocks are default_sample_block's (26, 41, 57: no multiple of
# 8 divides 130, 164 or 228). The MLP's seed gives every leaf of the
# reference a gradient (with seed 61 most of these MLPs' densities are
# ReLU-dead on every sample, and so is every gradient).
NERF_DOMAIN = [
    ("F6 hidden 320", 320, 64, 64, 192, 64, 2),
    ("F6 384/96", 384, 96, 64, 192, 64, 1),
    ("F6 512/128", 512, 128, 64, 128, 64, 1),
    ("F6 rgb_hidden 320", 128, 320, 64, 128, 64, 1),
    ("F7 S=65", 128, 64, 65, 130, 26, 1),
    ("F7 S=100", 128, 64, 100, 164, 41, 1),
    ("F7 union 228", 256, 64, 100, 228, 57, 1),
]


def _route_moved(fn, before, cfg, shape):
    """One launch of `fn` since `before`, on the configured routes."""
    from tinynerf_tpu_torch.kernels.fused_nerf_train import uses_tensor_cores

    now = (fn.launches, fn.mma_launches, fn.general_launches, fn.spill_launches)
    assert tuple(a - b for a, b in zip(now, before)) == (
        1, int(uses_tensor_cores(cfg)), int(shape.general), int(shape.spill)), (fn.__name__, shape)


def _counts(fn):
    return (fn.launches, fn.mma_launches, fn.general_launches, fn.spill_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("tag,hidden,rgb_hidden,S,union,block,seed", NERF_DOMAIN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nerf_kernels_take_every_width_and_sample_count_on_card(cuda_device, tag, hidden,
                                                                rgb_hidden, S, union, block, seed,
                                                                dtype):
    """K3 (weights out), K5, K4, K6 and the K7 pair at each F6 and F7 shape
    (the flagship's L 10, L_dir 4, depth 8, skip 4): one launch each on the
    route nerf_shape configures (the general kernel past 512 threads or a
    walk tile off whole chunks, X in device memory past 227 KB), within the
    render gates and the NeRF pass gates of their plain versions (bf16:
    the scale gate too; K7 on one-signed cotangents)."""
    import copy

    from tinynerf_tpu_torch.kernels import fused_nerf as k3
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k56
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels import fused_partials as k7
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.ops.volume import global_deltas

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=dtype)
    assert k3.default_sample_block(union, 64) == block
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed), device=cuda_device)
    names = [n for n, _ in mlp.named_parameters()]
    n = 200
    ro, rd = _rays(n, 62, cuda_device)
    target = torch.from_numpy(np.random.RandomState(63).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, union, 64, cuda_device)

    with torch.no_grad():
        before = _counts(k3.fused_nerf_render_rays)
        got, got_w = k3.fused_nerf_render_rays(mlp, ro, rd, n_samples=S, return_weights=True)
        _route_moved(k3.fused_nerf_render_rays, before, cfg, k3.nerf_shape(cfg, S, S, walk=False))
        want, want_w = k3.fused_nerf_render_rays_plain(mlp, ro, rd, n_samples=S,
                                                       return_weights=True)
        before = _counts(k56.fused_nerf_render_rays_streamed)
        got5 = k56.fused_nerf_render_rays_streamed(mlp, ro, rd, z, sample_block=block)
        _route_moved(k56.fused_nerf_render_rays_streamed, before, cfg,
                     k3.nerf_shape(cfg, union, block, walk=False))
        want5 = k56.fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z, sample_block=block)
    for a, b in ((got, want), (got_w, want_w), (got5, want5)):
        assert bool(torch.isfinite(a).all())
        _within_render_gates(a, b, dtype)

    # Density noise, as the recipes train with (--sigma-noise-std 1): these
    # random MLPs' densities are small, where f32's alpha = 1 - (exp(-sigma
    # delta) + 1e-10 - 1e-10) keeps few bits, and the noise keeps the f32
    # reference inside the gates' own allowance.
    g = torch.Generator(device=cuda_device).manual_seed(65)
    noise = torch.randn(n, union, generator=g, device=cuda_device)
    noise_c = noise[:, :S].contiguous()
    before = _counts(k4.fused_nerf_pass_grads)
    loss, grads, w, zk = k4.fused_nerf_pass_grads(mlp, ro, rd, target, 7, n_samples=S,
                                                  emit_sampling=True, sigma_noise=noise_c)
    _route_moved(k4.fused_nerf_pass_grads, before, cfg, k3.nerf_shape(cfg, S, S))
    ref = _plain(k4.fused_nerf_pass_grads_plain, mlp, ro, rd, target, 0, zk, dtype=dtype,
                 randomized=False, sigma_noise=noise_c)
    _live_leaves(ref, names)
    _leaf_check(loss, grads, ref, dtype, names=names)
    before = _counts(k56.fused_nerf_pass_grads_streamed)
    kw6 = dict(sigma_noise=noise, sample_block=block)
    loss, grads = k56.fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, **kw6)
    _route_moved(k56.fused_nerf_pass_grads_streamed, before, cfg,
                 k3.nerf_shape(cfg, union, block))
    ref = _plain(k56.fused_nerf_pass_grads_streamed_plain, mlp, ro, rd, target, z, dtype=dtype,
                 **kw6)
    _leaf_check(loss, grads, ref, dtype, names=names)

    deltas = global_deltas(z, rd)
    cot, _ = _partials_cotangents(n, union, cuda_device, seed=66, signed=False)
    before = [_counts(f) for f in (k7.fused_block_partials_fwd, k7.fused_block_partials_bwd)]
    partials, _ = k7.make_fused_block_partials_fn(cfg, sample_block=block)(mlp, ro, rd, z, deltas)
    keys = ("C", "A", "T", "D")
    grads = torch.autograd.grad([partials[k] for k in keys], list(mlp.parameters()),
                                grad_outputs=[cot[k] for k in keys])
    torch.cuda.synchronize()
    for f, b in zip((k7.fused_block_partials_fwd, k7.fused_block_partials_bwd), before):
        _route_moved(f, b, cfg, k3.nerf_shape(cfg, union, block))
    with torch.no_grad():
        want7, _ = k7.block_partials_plain(mlp, ro, rd, z, deltas, None, sample_block=block)
    for k in keys:
        scale = 6.0 if k == "D" else 1.0
        _within_render_gates(partials[k].detach().reshape(n, -1) / scale,
                             want7[k].reshape(n, -1) / scale, dtype)
    args = (ro, rd, z, deltas, None, cot, None)
    if dtype == torch.bfloat16:
        ref = k7.block_partials_grads_plain(mlp, *args, sample_block=block)
        assert min(_cosine(a, r) for a, r in zip(grads, ref)) > 0.98
        _scale_check(names, grads, ref)
    else:
        want64 = [a.float() for a in k7.block_partials_grads_plain(
            copy.deepcopy(mlp).double(), *args, sample_block=block)]
        plain32 = k7.block_partials_grads_plain(mlp, *args, sample_block=block)
        for a, r, p in zip(grads, want64, plain32):
            tol = 3e-4 * float(r.abs().max())
            assert float((a - r).abs().max()) <= tol + min(float((p - r).abs().max()), tol) + 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rgb_hidden", [(128, 64), (256, 64), (48, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_general_and_spill_routes_are_bit_identical_to_the_shared_route_on_card(
        cuda_device, hidden, rgb_hidden, dtype):
    """At recipe shapes (hidden 128 and the flagship's 256 on the tensor
    cores in bf16, hidden 48 on the CUDA cores), K3, K5, K4, K6 and the K7
    pair forced onto the general kernel and onto its spill route give the
    one-round kernel's results bit for bit: the rounds take each product's
    items in another order but sum each output in the same one, and X in
    device memory holds the same values."""
    from tinynerf_tpu_torch.kernels import fused_nerf as k3
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k56
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.kernels import fused_partials as k7
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.ops.volume import global_deltas

    cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=dtype)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(1), device=cuda_device)
    n = 300
    ro, rd = _rays(n, 62, cuda_device)
    target = torch.from_numpy(np.random.RandomState(69).rand(n, 3).astype(np.float32)).to(cuda_device)
    z = _sorted_z(n, 192, 70, cuda_device)
    noise = torch.randn(n, 192, generator=torch.Generator(device=cuda_device).manual_seed(71),
                        device=cuda_device)

    def runs(route):
        with torch.no_grad():
            out = [k3.fused_nerf_render_rays(mlp, ro, rd, n_samples=64, return_weights=True,
                                             route=route),
                   k3.fused_nerf_render_rays(mlp, ro, rd, z, route=route),
                   k56.fused_nerf_render_rays_streamed(mlp, ro, rd, z, sample_block=64,
                                                       route=route)]
        out.append(k4.fused_nerf_pass_grads(mlp, ro, rd, target, 9, n_samples=64,
                                            emit_sampling=True, route=route))
        out.append(k4.fused_nerf_pass_grads(mlp, ro, rd, target, 9, z[:, :128],
                                            sigma_noise=noise[:, :128], randomized=False,
                                            route=route))
        out.append(k56.fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, sigma_noise=noise,
                                                      sample_block=64, route=route))
        shard, sd = z[:, :96].contiguous(), global_deltas(z, rd)[:, :96].contiguous()
        shape = k3.launch_shape(cfg, 96, 48, walk=True, route=route)
        pad = -n % shape.tile_rays
        o, d = k3.pad_rays(ro, rd, pad)
        zp = torch.cat([shard, shard.new_ones(pad, 96)]).contiguous()
        dp = torch.cat([sd, sd.new_ones(pad, 96)]).contiguous()
        np_ = torch.cat([noise[:, :96], noise.new_zeros(pad, 96)]).contiguous()
        fwd = k7.fused_block_partials_fwd(mlp, cfg, o, d, zp, dp, np_, 48, shape, True)
        g_ray = torch.rand(n + pad, 6, generator=torch.Generator(device=cuda_device).manual_seed(72),
                           device=cuda_device) / n
        out.append(fwd[:3])
        out.append(k7.fused_block_partials_bwd(mlp, cfg, o, d, zp, dp, np_, fwd[1], g_ray, None,
                                               fwd[3], fwd[4], 48, shape))
        torch.cuda.synchronize()
        return out

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in flat(y)]

    shared = flat(runs(None))
    for route in ("general", "spill"):
        other = flat(runs(route))
        assert len(other) == len(shared)
        for i, (a, b) in enumerate(zip(shared, other)):
            assert torch.equal(a, b), (route, i)


@pytest.mark.cuda
def test_k4_k6_scene_axis_at_an_f6_width_bit_identical_on_card(cuda_device):
    """The scene axis of K4 and K6 on the general walk (hidden 320, 512
    threads in rounds), bf16: each scene of a batched launch bit-identical
    to its one-scene launch."""
    from tinynerf_tpu_torch.kernels import fused_nerf_stream as k56
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP
    from tinynerf_tpu_torch.models.stacked import scene_module

    cfg = NeRFConfig(hidden=320, rgb_hidden=64, compute_dtype=torch.bfloat16)
    model = _stacked(lambda g, d: NeRFMLP(cfg, generator=g, device=d), NERF_SCENE_SEEDS,
                     cuda_device)
    K, n = len(NERF_SCENE_SEEDS), 200
    ro, rd, target = _scene_rays(K, n, 73, cuda_device)
    seeds = torch.arange(5, 5 + K, dtype=torch.int32, device=cuda_device)
    before = _counts(k4.fused_nerf_pass_grads)
    loss, grads = k4.fused_nerf_pass_grads_scenes(model, ro, rd, target, seeds, n_samples=64,
                                                  cfg=cfg)
    assert _counts(k4.fused_nerf_pass_grads)[2] == before[2] + 1  # the general walk
    zf = torch.stack([_sorted_z(n, 192, 74 + k, cuda_device) for k in range(K)])
    loss6, grads6 = k56.fused_nerf_pass_grads_streamed_scenes(model, ro, rd, target, zf, cfg=cfg,
                                                             sample_block=64)
    for k in range(K):
        one = scene_module(model, k)
        l1, g1 = k4.fused_nerf_pass_grads(one, ro[k], rd[k], target[k], seeds[k:k + 1],
                                          n_samples=64, cfg=cfg)
        assert float(loss[k]) == float(l1) and all(torch.equal(a[k], b) for a, b in zip(grads, g1))
        l6, g6 = k56.fused_nerf_pass_grads_streamed(one, ro[k], rd[k], target[k], zf[k], cfg=cfg,
                                                    sample_block=64)
        assert float(loss6[k]) == float(l6)
        assert all(torch.equal(a[k], b) for a, b in zip(grads6, g6))


@pytest.mark.cuda
def test_nerf_shape_mirrors_the_c_formulas_and_c_refuses_off_route_on_card(cuda_device):
    """nerf_shape's byte and thread counts equal the C entries' own
    (tinynerf_fused_nerf_smem_bytes, _train_smem_bytes, _threads, the spill
    slab), and the C entries refuse a shape off its route with
    cudaErrorInvalidValue (1), nothing launched: the one-round walk at a
    tile off whole chunks, the one-round kernels past 512 threads, a spill
    slab on the one-round route, widths past MAX_GENERAL_WIDTH."""
    from tinynerf_tpu_torch.kernels import fused_nerf as k3
    from tinynerf_tpu_torch.kernels import fused_nerf_train as k4
    from tinynerf_tpu_torch.models.nerf import NeRFConfig

    l3, l4 = k3._lib(), k4._lib()
    for _, hidden, rgb_hidden, S, union, block, _ in NERF_DOMAIN:
        cfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden)
        geom = (cfg.num_freqs, cfg.num_freqs_dir, int(cfg.use_viewdirs))
        for seg, n_samples in ((S, S), (block, union)):
            for route in (None, "general", "spill"):
                w = k3.nerf_shape(cfg, n_samples, seg, route=route)
                assert w.smem_bytes == l4.tinynerf_fused_nerf_train_smem_bytes(
                    w.tile_rays, seg, n_samples, *geom, hidden, rgb_hidden, int(w.general),
                    int(w.spill))
                assert w.threads == l4.tinynerf_fused_nerf_train_threads(hidden, rgb_hidden,
                                                                         int(w.general))
                r = k3.nerf_shape(cfg, n_samples, seg, walk=False, route=route)
                assert r.smem_bytes == l3.tinynerf_fused_nerf_smem_bytes(
                    r.tile_rays, seg, *geom, hidden, rgb_hidden, int(r.spill))
                assert r.threads == l3.tinynerf_fused_nerf_threads(hidden, rgb_hidden,
                                                                   int(r.general))
        assert k3.spill_floats(cfg) == l3.tinynerf_fused_nerf_spill_floats(
            hidden, *geom, rgb_hidden) == l4.tinynerf_fused_nerf_train_spill_floats(
            hidden, *geom, rgb_hidden)

    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    dev = cuda_device.index
    dummy = torch.zeros(1, device=cuda_device).data_ptr()
    geom = (10, 4, 1)

    def k4_err(tile, S, hidden, rgb_hidden, general, spill):
        return l4.tinynerf_fused_nerf_train(
            *(None,) * 6, dummy, dummy, dummy, None, None, None, None, None, None, None, 4 * tile,
            4 * tile, tile, S, *geom, hidden, 8, 4, rgb_hidden, 2.0, 0.1, 0.01, 0, 1, 0, 1, 100,
            1, 0, 0, 0, general, spill, dev, stream)

    assert k4_err(16, 100, 128, 64, 0, None) == 1     # 1600 points: off whole chunks
    assert k4_err(2, 64, 320, 64, 0, None) == 1       # 640 threads on the one-round walk
    assert k4_err(2, 64, 128, 64, 0, dummy) == 1      # a spill slab on the one-round walk
    assert k4_err(2, 64, 4104, 64, 1, dummy) == 1     # past MAX_GENERAL_WIDTH
    assert l3.tinynerf_fused_nerf(None, None, None, None, None, None, None, 128, 1, 64, 10, 4, 1,
                                  320, 8, 4, 64, 2.0, 6.0, 0, 0, None, 1, dev, stream) == 1
    assert l3.tinynerf_fused_nerf(None, None, None, None, None, None, None, 128, 1, 64, 10, 4, 1,
                                  128, 8, 4, 64, 2.0, 6.0, 0, 0, dummy, 1, dev, stream) == 1
