"""The tensor-core fragment packer of the bf16 training walk of K4, K6 and
K7 (tinynerf_tpu_torch/kernels/fused_nerf_train.py::pack_mma_weights) and
of the bf16 render kernels K3/K5 (kernels/fused_nerf.py::pack_mma_forward,
its forward prefix) on the CPU: unpacking by index gives back every
layer's bf16 weights with their zero K-padding, and an emulation of
mma.sync m16n8k16 over the packed fragments, reading its A operands the
way csrc/mma_bf16.cuh does, computes the forward and upstream products,
the render's trunk and rgb_in forward from its own buffer and, over the
permuted points with a bias row of ones, the weight gradient; at widths
with and without view directions. The launch rules: off the tensor
cores' widths the training kernels and the render alike take the CUDA
cores, by configuration. The wrappers' CPU paths take the plain versions and count no
launch. No kernel runs. Imports neither jax nor the JAX package:

    python -m pytest -q tests/test_torch_port_mma_pack.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tinynerf_tpu_torch.kernels.fused_nerf import (
    mma_shapes_ok,
    pack_mma_forward,
    render_uses_tensor_cores,
)
from tinynerf_tpu_torch.kernels.fused_nerf_train import (
    mma_operands,
    pack_mma_b,
    pack_mma_weights,
    uses_tensor_cores,
)
from tinynerf_tpu_torch.models.nerf import NeRFConfig, NeRFMLP, nerf_layer_in_dims
from tinynerf_tpu_torch.models.tinynerf import dense

# (hidden, L, L_dir, view directions): the card tests' small width, hidden
# 128, the flagship, and the K4/K7 card width without view directions
# (rgb_in's input is the trunk alone: no direction rows, K = hidden).
WIDTHS = [(32, 4, 2, True), (128, 10, 4, True), (256, 10, 4, True), (256, 4, 2, True),
          (64, 10, 4, False)]
LOGICAL = (0, 1, 8, 9)  # logical k of a lane's value j, less 2t


def _mlp(hidden, num_freqs, dir_freqs, viewdirs=True, seed=0):
    depth, skip_at, rgb_hidden = (8, 4, 64) if hidden >= 128 else (3, 2, 16)
    cfg = NeRFConfig(num_freqs=num_freqs, num_freqs_dir=dir_freqs, hidden=hidden, depth=depth,
                     skip_at=skip_at, rgb_hidden=rgb_hidden, use_viewdirs=viewdirs,
                     compute_dtype=torch.bfloat16)
    return NeRFMLP(cfg, generator=torch.Generator().manual_seed(seed)), cfg


def _pad32(n):
    return -(-n // 32) * 32


def _unpack(flat, K, N):
    """Invert the packing by index: value j of lane (g, t) of k-step ks and
    tile nt is B[32 (ks // 2) + 8 t + 4 (ks % 2) + j][8 nt + g]."""
    kp = _pad32(K)
    frag = flat.reshape(kp // 16, N // 8, 32, 4)
    b = torch.empty(kp, N, dtype=flat.dtype)
    for ks in range(kp // 16):
        for lane in range(32):
            g, t = divmod(lane, 4)
            k = 32 * (ks // 2) + 8 * t + 4 * (ks % 2)
            b[k:k + 4, g::8] = frag[ks, :, lane, :].t()
    return b


def _emulate(a, flat, K, N):
    """sum over k-steps of A_log @ B_log, the m16n8k16 products in float64:
    lane (g, t) loads A's physical columns lane_k(ks, t) + j (zero from K
    on, the device's masked loads) and its packed B values as logical
    k = 2t + (0, 1, 8, 9)[j]."""
    kp = _pad32(K)
    frag = flat.double().reshape(kp // 16, N // 8, 32, 4)
    a = torch.cat([a.double(), a.new_zeros(a.shape[0], kp - K, dtype=torch.float64)], dim=1)
    out = torch.zeros(a.shape[0], N, dtype=torch.float64)
    for ks in range(kp // 16):
        a_log = torch.zeros(a.shape[0], 16, dtype=torch.float64)
        b_log = torch.zeros(16, N, dtype=torch.float64)
        for lane in range(32):
            g, t = divmod(lane, 4)
            k = 32 * (ks // 2) + 8 * t + 4 * (ks % 2)
            for j, d in enumerate(LOGICAL):
                a_log[:, 2 * t + d] = a[:, k + j]
                b_log[2 * t + d, g::8] = frag[ks, :, lane, j]
        out += a_log @ b_log
    return out


@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs", WIDTHS)
def test_unpacking_gives_back_the_bf16_weights(hidden, num_freqs, dir_freqs, viewdirs):
    mlp, cfg = _mlp(hidden, num_freqs, dir_freqs, viewdirs)
    flat = pack_mma_weights(mlp, cfg)
    assert flat.dtype == torch.bfloat16
    h, rh, dd = cfg.hidden, cfg.rgb_hidden, cfg.dir_dim
    # The device's offsets (nerf_train_walk.cuh: mma_fwd_off, mma_up):
    # forward blocks pad32(in) x out, upstream blocks pad32(out) x hidden.
    ins = nerf_layer_in_dims(cfg)
    shapes = [(n, h) for n in ins] + [(h + dd, rh)] + [(h, h)] * (cfg.depth - 1) + [(rh, h)]
    assert flat.numel() == sum(_pad32(k) * n for k, n in shapes)
    assert flat.numel() % 4 == 0  # whole 8-byte loads
    want = [lin.weight.detach().to(torch.bfloat16) for lin in mlp.layers]
    rgb_in = mlp.rgb_in.weight.detach().to(torch.bfloat16)
    wants = [w.t() for w in want] + [rgb_in.t()] + [w[:, :h] for w in want[1:]] + [rgb_in[:, :h]]
    off = 0
    for (name, _), (K, N), w in zip(mma_operands(mlp, cfg), shapes, wants):
        size = _pad32(K) * N
        b = _unpack(flat[off:off + size], K, N)
        assert torch.equal(b[:K], w), name
        assert not bool(b[K:].any()), f"{name}: K padding is zero"
        off += size
    assert off == flat.numel()


@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs", WIDTHS)
def test_emulated_mma_over_the_fragments_computes_the_products(hidden, num_freqs, dir_freqs,
                                                               viewdirs):
    mlp, cfg = _mlp(hidden, num_freqs, dir_freqs, viewdirs, seed=1)
    rng = np.random.RandomState(hidden + num_freqs)
    h = cfg.hidden
    for name, b in mma_operands(mlp, cfg):
        K, N = b.shape
        # Forward: 128 point rows of bf16 inputs; upstream: 64 points of
        # bf16 output gradients (the walk rounds both where it writes them).
        rows = 128 if name.endswith(".fwd") else 64
        a = torch.from_numpy(rng.randn(rows, K).astype(np.float32)).to(torch.bfloat16).float()
        got = _emulate(a, pack_mma_b(b), K, N)
        want = a.double() @ b.double()
        if name.endswith(".up"):  # G @ W[:, :hidden], nn.Linear's (out, in) weight
            lin = mlp.rgb_in if name == "rgb_in.up" else mlp.layers[int(name.split(".")[1])]
            want = a.double() @ lin.weight.detach().to(torch.bfloat16).double()[:, :h]
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("hidden,rgb_hidden,ok", [
    (256, 64, True), (128, 64, True), (32, 16, True), (64, 16, True),
    (256, 32, False),  # rgb_in's 32 columns over 8 warp pairs: 4 each
    (48, 24, False),   # hidden not a multiple of 32
])
def test_mma_shape_rule(hidden, rgb_hidden, ok):
    """The shape rule, and the route of K4, K6 and K7 on it, by
    configuration: bf16 takes the tensor cores exactly at the widths they
    take and the CUDA-core walk elsewhere, f32 the CUDA cores at any width;
    the rule never raises."""
    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=hidden, depth=3, skip_at=2,
                     rgb_hidden=rgb_hidden, compute_dtype=torch.bfloat16)
    assert mma_shapes_ok(cfg) is ok
    assert uses_tensor_cores(cfg) is ok
    assert uses_tensor_cores(dataclasses.replace(cfg, compute_dtype=torch.float32)) is False


@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs", WIDTHS)
def test_emulated_weight_gradient_takes_each_point_once_and_one_bias_row(hidden, num_freqs,
                                                                          dir_freqs, viewdirs):
    """mma_bf16.cuh's mma_weight_grad: over the 4 k-steps of a 64-point
    chunk the lanes' permuted points (lane_k) cover every point once, and
    the input row after the last (a row of ones) gives the bias gradient:
    part = [In^T G; sum_p G] for each layer's input width."""
    mlp, cfg = _mlp(hidden, num_freqs, dir_freqs, viewdirs, seed=2)
    rng = np.random.RandomState(hidden + 7 * num_freqs)
    seen = sorted(32 * (ks // 2) + 8 * t + 4 * (ks % 2) + j
                  for ks in range(4) for t in range(4) for j in range(4))
    assert seen == list(range(64))
    for n_in in sorted(set(nerf_layer_in_dims(cfg) + [cfg.hidden + cfg.dir_dim])):
        x = torch.from_numpy(rng.randn(64, n_in)).to(torch.bfloat16).double()
        gr = torch.from_numpy(rng.randn(64, 8)).to(torch.bfloat16).double()
        rows = torch.cat([x, torch.ones(64, 1, dtype=torch.float64)], dim=1)  # rows m <= n_in
        part = torch.zeros(n_in + 1, 8, dtype=torch.float64)
        for ks in range(4):
            a_log = torch.zeros(n_in + 1, 16, dtype=torch.float64)
            b_log = torch.zeros(16, 8, dtype=torch.float64)
            for t in range(4):
                p = 32 * (ks // 2) + 8 * t + 4 * (ks % 2)
                for j, d in enumerate(LOGICAL):
                    a_log[:, 2 * t + d] = rows[p + j]
                    b_log[2 * t + d] = gr[p + j]
            part += a_log @ b_log
        want = torch.cat([x.t() @ gr, gr.sum(0, keepdim=True)])
        assert float((part - want).abs().max()) <= 1e-9 * float(want.abs().max()), n_in


def _cpu_inputs(n=8, S=16, seed=3):
    rng = np.random.RandomState(seed)
    ro = torch.from_numpy((rng.randn(n, 3) * 0.1 + [0, 0, 4]).astype(np.float32))
    rd = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    tgt = torch.from_numpy(rng.rand(n, 3).astype(np.float32))
    z = torch.from_numpy(np.sort(rng.uniform(2, 6, (n, S)).astype(np.float32), axis=1))
    return ro, rd, tgt, z


def test_plain_path_on_the_cpu_counts_no_launch():
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed

    mlp, cfg = _mlp(32, 4, 2)
    ro, rd, tgt, z = _cpu_inputs()
    before = (fused_nerf_pass_grads_streamed.launches, fused_nerf_pass_grads_streamed.mma_launches)
    with torch.enable_grad():
        loss, grads = fused_nerf_pass_grads_streamed(mlp, ro, rd, tgt, z, cfg=cfg, sample_block=8)
    assert bool(torch.isfinite(loss)) and len(grads) == len(list(mlp.parameters()))
    assert (fused_nerf_pass_grads_streamed.launches,
            fused_nerf_pass_grads_streamed.mma_launches) == before


def _k4_on_the_cpu(mlp, cfg, ro, rd, tgt, z):
    from tinynerf_tpu_torch.kernels.fused_nerf_train import (
        fused_nerf_pass_grads,
        fused_nerf_pass_grads_plain,
    )

    got = fused_nerf_pass_grads(mlp, ro, rd, tgt, 3, n_samples=16, emit_sampling=True, cfg=cfg)
    want = fused_nerf_pass_grads_plain(mlp, ro, rd, tgt, 3, n_samples=16, emit_sampling=True,
                                       cfg=cfg)
    return [got[0], *got[1], *got[2:]], [want[0], *want[1], *want[2:]]


def _k7_on_the_cpu(mlp, cfg, ro, rd, tgt, z):
    from tinynerf_tpu_torch.kernels.fused_partials import (
        block_partials_grads_plain,
        block_partials_plain,
        make_fused_block_partials_fn,
    )
    from tinynerf_tpu_torch.ops.volume import global_deltas

    deltas = global_deltas(z, rd)
    cot = {"C": tgt, "A": tgt[:, 0], "T": tgt[:, 1], "D": tgt[:, 2]}
    partials, w = make_fused_block_partials_fn(cfg, emit_weights=True, sample_block=8)(
        mlp, ro, rd, z, deltas)
    outs = [partials[k] for k in ("C", "A", "T", "D")] + [w]
    grads = torch.autograd.grad(outs, list(mlp.parameters()),
                                grad_outputs=[cot[k] for k in ("C", "A", "T", "D")] + [z])
    with torch.no_grad():
        want, want_w = block_partials_plain(mlp, ro, rd, z, deltas, cfg=cfg, sample_block=8,
                                            emit_weights=True)
    want_grads = block_partials_grads_plain(mlp, ro, rd, z, deltas, None, cot, z, cfg=cfg,
                                            sample_block=8)
    return ([o.detach() for o in outs] + list(grads),
            [want[k] for k in ("C", "A", "T", "D")] + [want_w] + list(want_grads))


@pytest.mark.parametrize("run,wrappers", [
    (_k4_on_the_cpu, ("fused_nerf_train.fused_nerf_pass_grads",)),
    (_k7_on_the_cpu, ("fused_partials.fused_block_partials_fwd",
                      "fused_partials.fused_block_partials_bwd")),
])
def test_bf16_k4_and_k7_take_the_plain_versions_on_the_cpu(run, wrappers):
    """bf16 K4 and K7 on CPU tensors: the plain versions' values, and
    neither .launches nor .mma_launches moves (the tensor-core walk runs
    only on the card)."""
    import importlib

    fns = []
    for w in wrappers:
        mod, name = w.split(".")
        fns.append(getattr(importlib.import_module(f"tinynerf_tpu_torch.kernels.{mod}"), name))
    mlp, cfg = _mlp(32, 4, 2)
    before = [(f.launches, f.mma_launches) for f in fns]
    with torch.enable_grad():
        got, want = run(mlp, cfg, *_cpu_inputs())
    assert [(f.launches, f.mma_launches) for f in fns] == before
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def _mma_fwd_off(cfg, i):
    """csrc/mma_bf16.cuh's mma_fwd_off: trunk layer i's forward fragments
    (i = depth: rgb_in's), in bf16 values."""
    return sum(_pad32(n) * cfg.hidden for n in nerf_layer_in_dims(cfg)[:i])


@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs", WIDTHS)
def test_render_forward_buffer_is_the_prefix_of_the_walks(hidden, num_freqs, dir_freqs,
                                                          viewdirs):
    """K3/K5's w_mma holds the trunk layers' and rgb_in's forward fragments
    at the training walk's offsets: the prefix of pack_mma_weights."""
    mlp, cfg = _mlp(hidden, num_freqs, dir_freqs, viewdirs, seed=4)
    fwd, full = pack_mma_forward(mlp, cfg), pack_mma_weights(mlp, cfg)
    assert fwd.dtype == torch.bfloat16 and fwd.is_contiguous()
    n = _mma_fwd_off(cfg, cfg.depth) + _pad32(cfg.hidden + cfg.dir_dim) * cfg.rgb_hidden
    assert fwd.numel() == n and fwd.numel() % 4 == 0
    assert torch.equal(fwd, full[:n])


@pytest.mark.parametrize("hidden,num_freqs,dir_freqs,viewdirs", WIDTHS)
@torch.no_grad()
def test_emulated_render_forward_over_its_buffer_is_the_models(hidden, num_freqs, dir_freqs,
                                                               viewdirs):
    """The render's tensor-core forward, emulated over pack_mma_forward's
    buffer at mma_fwd_off: each trunk layer and rgb_in, on the same bf16
    inputs, gives the model's own pre-activation (dense) to float32
    rounding; chained as the kernel chains them (bias, ReLU, bf16 rounding,
    the skip concat, the direction encoding over the dead columns) the
    heads give the model's rgb and sigma within the bf16 render gate."""
    mlp, cfg = _mlp(hidden, num_freqs, dir_freqs, viewdirs, seed=5)
    buf = pack_mma_forward(mlp, cfg)
    rng = np.random.RandomState(hidden + 3 * num_freqs)
    bf = torch.bfloat16
    x_enc = torch.from_numpy(rng.uniform(-1, 1, (128, cfg.in_dim)).astype(np.float32)).to(bf).float()
    d_enc = torch.from_numpy(rng.uniform(-1, 1, (128, cfg.dir_dim)).astype(np.float32)).to(bf).float()

    def layer(a, lin, off):
        K, N = a.shape[1], lin.out_features
        got = _emulate(a, buf[off:off + _pad32(K) * N], K, N) + lin.bias.detach().double()
        want = dense(a, lin, bf).double()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6
        return torch.relu(got).float().to(bf).float()

    h = x_enc
    for i, lin in enumerate(mlp.layers):
        h = layer(h, lin, _mma_fwd_off(cfg, i))
        if i == cfg.skip_at - 1:
            h = torch.cat([h, x_enc], dim=-1)
    sigma = torch.relu(dense(h, mlp.sigma, bf))
    g = layer(torch.cat([h, d_enc], dim=-1), mlp.rgb_in, _mma_fwd_off(cfg, cfg.depth))
    rgb = torch.sigmoid(dense(g, mlp.rgb, bf))
    want_rgb, want_sigma = mlp(x_enc, d_enc if viewdirs else None, cfg)
    assert float((rgb - want_rgb).abs().max()) < 3e-2
    assert float((sigma - want_sigma).abs().max()) < 3e-2 * max(1.0, float(want_sigma.abs().max()))


@pytest.mark.parametrize("hidden,rgb_hidden,dtype,want", [
    (128, 64, torch.bfloat16, True),   # the --n-fine 448 recipe
    (256, 64, torch.bfloat16, True),   # the flagship
    (32, 16, torch.bfloat16, True),    # the card tests' small width
    (256, 64, torch.float32, False),   # f32: the CUDA cores, the exactness reference
    (48, 24, torch.bfloat16, False),   # hidden not a multiple of 32
    (256, 32, torch.bfloat16, False),  # rgb_in's 32 columns over 8 warp pairs: 4 each
    (256, 192, torch.bfloat16, False), # 3 column tiles a warp: no instantiation
])
def test_render_route_by_configuration_never_raises(hidden, rgb_hidden, dtype, want):
    """K3/K5 take the tensor cores for bf16 at the widths they take and the
    CUDA cores otherwise, where the training kernels raise."""
    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=hidden, depth=3, skip_at=2,
                     rgb_hidden=rgb_hidden, compute_dtype=dtype)
    assert render_uses_tensor_cores(cfg) is want
    if dtype == torch.bfloat16:
        assert mma_shapes_ok(cfg) is want


@pytest.mark.parametrize("hidden,rgb_hidden", [(32, 16), (48, 24)])
def test_bf16_k3_and_k5_take_the_plain_versions_on_the_cpu(hidden, rgb_hidden):
    """bf16 K3 (weights out) and K5 on CPU tensors, on and off the tensor
    cores' widths: the plain versions' values, and neither .launches nor
    .mma_launches moves."""
    from tinynerf_tpu_torch.kernels.fused_nerf import (
        fused_nerf_render_rays,
        fused_nerf_render_rays_plain,
    )
    from tinynerf_tpu_torch.kernels.fused_nerf_stream import (
        fused_nerf_render_rays_streamed,
        fused_nerf_render_rays_streamed_plain,
    )

    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=hidden, depth=3, skip_at=2,
                     rgb_hidden=rgb_hidden, compute_dtype=torch.bfloat16)
    mlp = NeRFMLP(cfg, generator=torch.Generator().manual_seed(6))
    ro, rd, _, z = _cpu_inputs()
    fns = (fused_nerf_render_rays, fused_nerf_render_rays_streamed)
    before = [(f.launches, f.mma_launches) for f in fns]
    with torch.no_grad():
        got = [*fused_nerf_render_rays(mlp, ro, rd, z, cfg=cfg, return_weights=True),
               fused_nerf_render_rays_streamed(mlp, ro, rd, z, cfg=cfg, sample_block=8)]
        want = [*fused_nerf_render_rays_plain(mlp, ro, rd, z, cfg=cfg, return_weights=True),
                fused_nerf_render_rays_streamed_plain(mlp, ro, rd, z, cfg=cfg, sample_block=8)]
    assert [(f.launches, f.mma_launches) for f in fns] == before
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
