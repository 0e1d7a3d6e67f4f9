"""The plain reference against hand values at tiny sizes."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gpubench.reference import common, nerf, philox, tinynerf


@pytest.mark.parametrize("ctr, key, out", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, out):
    """Random123's known-answer vectors of Philox4x32-10."""
    assert tuple(int(w) for w in philox.philox4x32_10(ctr, key)) == out


def test_jitter_depths_by_hand():
    seed, S = 1234567, 8
    z = philox.jitter_depths(seed, 3, S, 2.0, 6.0)
    h = np.float32(4.0 / 7.0)
    for r, s in ((0, 0), (2, 5), (1, 7)):
        word = int(philox.philox4x32_10((s // 4, 0, r, 0), (seed, 0))[s % 4])
        u = np.float32((word & 0xFFFFFF) / 16777216.0)
        grid = np.float32(2.0) + h * np.float32(s)
        lower = grid if s == 0 else grid - np.float32(0.5) * h
        upper = grid if s == S - 1 else grid + np.float32(0.5) * h
        assert z[r, s] == np.float32(lower + (upper - lower) * u)
    assert (z[:, 0] >= 2.0).all() and (z[:, -1] <= 6.0).all()
    assert (np.diff(z, axis=1) >= 0).all()


def test_composite_by_hand():
    rgb = torch.tensor([[[0.2, 0.4, 0.6], [0.9, 0.9, 0.9]]])
    sigma = torch.tensor([[1.0, 0.0]])
    z = torch.tensor([[2.0, 3.0]])
    colour, w = common.composite(rgb, sigma, z, torch.tensor([[0.0, 0.0, 2.0]]))
    a0 = 1.0 - math.exp(-2.0)  # delta 1 times |d| = 2
    assert w[0, 0].item() == pytest.approx(a0) and w[0, 1].item() == 0.0
    expect = [a0 * c + (1.0 - a0) for c in (0.2, 0.4, 0.6)]
    assert colour[0].tolist() == pytest.approx(expect, rel=1e-6)


def test_sample_pdf_by_hand():
    bins = torch.tensor([[0.0, 1.0, 2.0]])
    # All the weight in the second bin: every quantile lands in [1, 2].
    got = common.sample_pdf(bins, torch.tensor([[0.0, 1.0]]), 3,
                            torch.tensor([[0.0, 0.5, 1.0]]), eps=0.0)
    assert got[0].tolist() == pytest.approx([1.0, 1.5, 2.0])


def test_encoding_order():
    x = torch.tensor([[0.5, -1.0, 2.0]])
    e = common.encode(x, 2)
    assert e.shape == (1, 15)
    assert e[0, 3:6].tolist() == pytest.approx(torch.sin(x)[0].tolist())
    assert e[0, 12:15].tolist() == pytest.approx(torch.cos(2 * x)[0].tolist())


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p = torch.randn(5, 3, generator=g)
    grads = [torch.randn(5, 3, generator=g) for _ in range(3)]
    W, state = {"p": p.clone()}, {}
    ref = torch.nn.Parameter(p.clone())
    opt = torch.optim.Adam([ref], lr=5e-4, betas=(0.9, 0.999), eps=1e-8)
    for gr in grads:
        common.adam_step(W, {"p": gr}, state, 5e-4)
        ref.grad = gr.clone()
        opt.step()
    assert torch.allclose(W["p"], ref.detach(), rtol=1e-6, atol=1e-9)


def test_fp8_control_rounds_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    e8 = ((common.fp8(x) - x).abs() / x.abs().clamp(min=1e-3)).median().item()
    e16 = ((x.to(torch.bfloat16).float() - x).abs() / x.abs().clamp(min=1e-3)).median().item()
    assert e8 > 8 * e16 and e8 < 0.1


def test_fp8_linear_gradients_flow():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(8, 5, generator=g, requires_grad=True)
    w = torch.randn(3, 5, generator=g, requires_grad=True)
    b = torch.zeros(3, requires_grad=True)
    common.linear(x, w, b, "fp8").sum().backward()
    assert torch.allclose(w.grad, torch.ones(8, 3).t() @ x.detach(), rtol=0.15, atol=0.3)


@pytest.mark.parametrize("module, n_params", [(tinynerf, 66308), (nerf, 2 * 530052)])
def test_init_is_uniform_in_the_fan_in_bound(module, n_params):
    cfg = {"num_freqs": 10, "num_freqs_dir": 4, "hidden": 256, "depth": 8, "skip_at": 4,
           "rgb_hidden": 128} if module is nerf else {"num_freqs": 10, "hidden": 128,
                                                       "depth": 4, "skip_at": 2}
    W = module.init_weights(cfg, torch.Generator().manual_seed(3), "cpu")
    assert sum(v.numel() for v in W.values()) == n_params
    for name, v in W.items():
        fan_in = dict(module.layer_shapes(cfg))[name.rsplit(".", 1)[0].split(".", 1)[-1]
                                                if module is nerf else
                                                name.rsplit(".", 1)[0]][1]
        assert v.abs().max() <= math.sqrt((6.0 if v.dim() == 2 else 1.0) / fan_in)


def test_scene_seed_is_the_splitmix_of_seed_and_scene():
    assert common.scene_seed(0, 0) != common.scene_seed(0, 1)
    assert 0 <= common.scene_seed(2**31 + 5, 7) < 2**31
