"""The NeRF kernels' (K3-K7) widths on the CPU: the width rule that the
CUDA-core products once imposed (hidden and rgb_hidden multiples of 8,
8 * rgb_hidden / hidden in {1, 2, 4, 8}) is gone; widths that are not
multiples of 8 reach the kernels zero-padded (kernels/fused_nerf.py:
padded_widths), which is exact, and the padded gradient entries are
dropped (unpad_grads). The packers' layouts at the padded widths, the
block's thread count, and the routes: the F3 widths take the CUDA cores.
No kernel runs. Imports neither jax nor the JAX package:

    python -m pytest -q tests/test_torch_port_widths.py
"""

import dataclasses

import pytest
import torch

from tinynerf_tpu_torch.kernels.fused_nerf import (
    block_threads,
    check_mlp,
    fused_nerf_render_rays,
    fused_nerf_render_rays_plain,
    pack_nerf_weights,
    padded_widths,
    render_uses_tensor_cores,
    unpad_grads,
)
from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    grad_layout,
    pack_backward_weights,
    pass_grads_plain,
    uses_tensor_cores,
)
from tinynerf_tpu_torch.kernels.fused_partials import block_partials_grads_plain
from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP

# F3's example (hidden 48 with the default rgb_hidden 64), a width pair
# that is not a multiple of 8, one with rgb_hidden far wider than hidden,
# and the flagship (no padding).
WIDTHS = [(48, 64), (36, 20), (12, 5), (256, 64)]


@pytest.fixture(autouse=True)
def _grad_enabled():
    # tests/test_torch_parity.py turns autograd off for its whole worker.
    with torch.enable_grad():
        yield


def case(hidden, rgb_hidden, dtype=torch.float32, seed=0):
    cfg = NeRFConfig(num_freqs=3, num_freqs_dir=2, hidden=hidden, depth=4, skip_at=2,
                     rgb_hidden=rgb_hidden, compute_dtype=dtype)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    ro = torch.randn(24, 3, generator=g) * 0.1
    rd = torch.randn(24, 3, generator=g)
    z = torch.sort(2.0 + 4.0 * torch.rand(24, 8, generator=g), dim=1).values
    target = torch.rand(24, 3, generator=g)
    return mlp, cfg, ro, rd, z, target


@pytest.mark.parametrize("hidden,rgb_hidden", WIDTHS)
def test_check_mlp_takes_any_width(hidden, rgb_hidden):
    mlp, cfg, *_ = case(hidden, rgb_hidden)
    check_mlp(mlp, cfg)
    with pytest.raises(ValueError, match="skip_at"):
        check_mlp(mlp, dataclasses.replace(cfg, skip_at=cfg.depth))
    with pytest.raises(ValueError, match="do not match"):
        check_mlp(mlp, dataclasses.replace(cfg, rgb_hidden=rgb_hidden + 1))


@pytest.mark.parametrize("hidden,rgb_hidden", WIDTHS)
def test_padded_widths_round_to_8_with_zero_units(hidden, rgb_hidden):
    mlp, cfg, *_ = case(hidden, rgb_hidden)
    mlp_p, cfg_p = padded_widths(mlp, cfg)
    hp, rp = -(-hidden // 8) * 8, -(-rgb_hidden // 8) * 8
    assert (cfg_p.hidden, cfg_p.rgb_hidden) == (hp, rp)
    if (hp, rp) == (hidden, rgb_hidden):
        assert mlp_p is mlp and cfg_p is cfg
        return
    check_mlp(mlp_p, cfg_p)
    # The packed buffer: every weight and bias of the padded units zero,
    # the real ones the model's, in the layout of the padded widths.
    w, w_p = pack_nerf_weights(mlp, cfg), pack_nerf_weights(mlp_p, cfg_p)
    assert w_p.numel() == sum(v.numel() for v in grad_layout(cfg_p).values()) + 3
    assert int((w_p != 0).sum()) == int((w != 0).sum())
    assert torch.equal(torch.sort(w_p[w_p != 0]).values, torch.sort(w[w != 0]).values)
    assert pack_backward_weights(mlp_p, cfg_p).numel() == (cfg.depth - 1) * hp * hp + rp * hp
    # Unpadding the padded MLP's own parameters gives back the model's.
    back = unpad_grads([p.detach() for p in mlp_p.parameters()], cfg, cfg_p)
    for a, b in zip(back, mlp.parameters()):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("hidden,rgb_hidden", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padding_is_exact(hidden, rgb_hidden, dtype):
    """The padded MLP renders the same image and, unpadded, has the same
    loss and gradients (the plain versions, the kernels' CPU path): a
    padded unit is ReLU(0) = 0, and in bf16 its zeros round to 0."""
    mlp, cfg, ro, rd, z, target = case(hidden, rgb_hidden, dtype)
    mlp_p, cfg_p = padded_widths(mlp, cfg)
    with torch.no_grad():
        a = fused_nerf_render_rays_plain(mlp, ro, rd, z, cfg=cfg)
        b = fused_nerf_render_rays_plain(mlp_p, ro, rd, z, cfg=cfg_p)
    assert float((a - b).abs().max()) <= 1e-6
    l1, g1, _ = pass_grads_plain(mlp, ro, rd, target, z, None, True, cfg, 4)
    l2, g2, _ = pass_grads_plain(mlp_p, ro, rd, target, z, None, True, cfg_p, 4)
    assert abs(float(l1) - float(l2)) <= 1e-7
    g2 = unpad_grads(g2, cfg, cfg_p)
    for x, y, p in zip(g1, g2, mlp.parameters()):
        assert x.shape == y.shape == p.shape
        assert float((x - y).abs().max()) <= 1e-6 * max(1.0, float(x.abs().max()))
    # K7's backward through the padded MLP, unpadded, too.
    deltas = torch.ones_like(z) * 0.1
    cot = {k: torch.full(s, 0.5) for k, s in (("C", (24, 3)), ("A", (24,)), ("T", (24,)),
                                                ("D", (24,)))}
    k1 = block_partials_grads_plain(mlp, ro, rd, z, deltas, None, cot, cfg=cfg, sample_block=4)
    k2 = unpad_grads(block_partials_grads_plain(mlp_p, ro, rd, z, deltas, None, cot, cfg=cfg_p,
                                                sample_block=4), cfg, cfg_p)
    for x, y in zip(k1, k2):
        assert float((x - y).abs().max()) <= 1e-6 * max(1.0, float(x.abs().max()))


@pytest.mark.parametrize("hidden,rgb_hidden,threads", [(48, 64, 128), (36, 20, 80), (12, 5, 32),
                                                       (256, 64, 512), (64, 8, 128)])
def test_block_threads_cover_the_widest_product(hidden, rgb_hidden, threads):
    """2 * max(hidden, rgb_hidden) at the padded widths
    (csrc/nerf_mlp.cuh: block_threads)."""
    mlp, cfg, *_ = case(hidden, rgb_hidden)
    _, cfg_p = padded_widths(mlp, cfg)
    assert block_threads(cfg_p) == threads


@pytest.mark.parametrize("hidden,rgb_hidden", WIDTHS[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f3_widths_route_to_the_cuda_cores(hidden, rgb_hidden, dtype):
    """By configuration, the F3 widths take the CUDA-core kernels in f32 and
    bf16 alike (the tensor cores' layout needs hidden % 32 == 0 and 4 *
    rgb_hidden / hidden in {1, 2, 4}); the flagship's bf16 takes the
    tensor cores."""
    _, cfg, *_ = case(hidden, rgb_hidden, dtype)
    assert not uses_tensor_cores(cfg) and not render_uses_tensor_cores(cfg)
    _, flagship, *_ = case(256, 64, torch.bfloat16)
    assert uses_tensor_cores(flagship) and render_uses_tensor_cores(flagship)


def test_cpu_wrappers_take_any_width_without_a_launch():
    """The wrappers' CPU path (the plain versions) at F3's widths: no
    launch counted, shapes of the model's parameters."""
    mlp, cfg, ro, rd, z, target = case(36, 20)
    before = (fused_nerf_render_rays.launches, fused_nerf_pass_grads_streamed.launches)
    with torch.no_grad():
        img = fused_nerf_render_rays(mlp, ro, rd, z, cfg=cfg)
    loss, grads = fused_nerf_pass_grads_streamed(mlp, ro, rd, target, z, cfg=cfg, sample_block=4)
    assert img.shape == (24, 3) and bool(torch.isfinite(loss))
    assert [g.shape for g in grads] == [p.shape for p in mlp.parameters()]
    assert (fused_nerf_render_rays.launches, fused_nerf_pass_grads_streamed.launches) == before
