"""The tensor-core fragments and routes of the TinyNeRF kernels K1 (render)
and K2 (train) on the CPU, at small widths.

kernels/fused_render.py::pack_tiny_weights packs K1's buffer (every trunk
layer's forward W^T) and K2's (the same, then the upstream W[:, :hidden]
of layers 1..depth-1) from one concatenation of the parameters and one
gather. Unpacking by index gives back the bf16 weights; an emulation of
mma.sync m16n8k16 over the buffers, reading A the way csrc/mma_bf16.cuh
does (tests/test_torch_port_mma_pack.py's), gives K1's forward (the TinyNeRF bf16 forward, and the JAX
package's apply_tinynerf on the same weights within the bf16 render
gates) and K2's weight gradients and upstream gradients (autograd's, the
skip layer's bias row counted once). Also K2's partial rows (even
stride, padding skipped), the route rules (never raising; f32 and
off-layout shapes on the CUDA cores) and the wrappers' CPU paths (the
plain versions, no launch counted). No kernel runs:

    python -m pytest -q tests/test_torch_port_tiny_mma.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_mma_pack import LOGICAL, _emulate, _pad32, _unpack
from tinynerf_tpu.models import tinynerf as jmodel
from tinynerf_tpu_torch.kernels.fused_nerf import pack_mma_b
from tinynerf_tpu_torch.kernels.fused_render import (
    fused_render_rays,
    fused_render_rays_plain,
    k1_uses_tensor_cores,
    pack_tiny_weights,
    pack_weights,
    tiny_mma_operands,
)
from tinynerf_tpu_torch.kernels.fused_train import (
    _scatter_index,
    fused_loss_grads,
    fused_loss_grads_plain,
    k2_uses_tensor_cores,
    pack_backward_weights,
    partial_row,
)
from tinynerf_tpu_torch.models.tinynerf import (
    TinyNeRF,
    TinyNeRFConfig,
    dense,
    layer_in_dims,
    params_to_jax,
)
from tinynerf_tpu_torch.ops.encoding import encoding_dim

BF = torch.bfloat16
# (hidden, L): small widths, depth 4, skip 2.
WIDTHS = [(32, 2), (32, 4), (64, 4), (64, 10), (32, 10)]


@pytest.fixture(autouse=True)
def _grad_on():
    # tests/test_torch_parity.py turns autograd off for its whole worker.
    with torch.enable_grad():
        yield


def _model(hidden, num_freqs, dtype=BF, seed=0):
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    return TinyNeRF(cfg, generator=torch.Generator().manual_seed(seed)), cfg


def _lane_k(ks, t):
    """csrc/mma_bf16.cuh's lane_k: the lane's first physical k of k-step ks."""
    return 32 * (ks // 2) + 8 * t + 4 * (ks % 2)


def _emulate_weight_grad(x, g):
    """mma_weight_grad over one 64-point chunk in float64: the input rows
    x (64, n) then ONE row of ones (the bias), as A (rows m, k = points in
    the lanes' permuted order), times the gradient g (64, N) -> (n + 1, N)."""
    rows = torch.cat([x.double(), torch.ones(64, 1, dtype=torch.float64)], dim=1)
    part = torch.zeros(rows.shape[1], g.shape[1], dtype=torch.float64)
    for ks in range(4):
        a_log = torch.zeros(rows.shape[1], 16, dtype=torch.float64)
        b_log = torch.zeros(16, g.shape[1], dtype=torch.float64)
        for t in range(4):
            for j, d in enumerate(LOGICAL):
                a_log[:, 2 * t + d] = rows[_lane_k(ks, t) + j]
                b_log[2 * t + d] = g[_lane_k(ks, t) + j].double()
        part += a_log @ b_log
    return part


def _fwd_off(cfg, i):
    """csrc/mma_bf16.cuh's mma_fwd_off: trunk layer i's forward fragments
    (i = depth: the first upstream operand's), in bf16 values."""
    return sum(_pad32(n) * cfg.hidden for n in layer_in_dims(cfg)[:i])


def _round(x):
    return x.to(BF).to(x.dtype)


@pytest.mark.parametrize("hidden,num_freqs", WIDTHS)
@pytest.mark.parametrize("upstream", [False, True], ids=["K1", "K2"])
def test_fragment_buffers_unpack_to_the_bf16_weights(hidden, num_freqs, upstream):
    model, cfg = _model(hidden, num_freqs)
    w_fwd, flat = pack_tiny_weights(model, cfg, mma=True, upstream=upstream)
    assert flat.dtype == BF and flat.is_contiguous() and flat.numel() % 4 == 0
    assert torch.equal(w_fwd, pack_weights(model, cfg))
    h = cfg.hidden
    ws = [lin.weight.detach().to(BF) for lin in model.layers]
    wants = [w.t() for w in ws] + ([w[:, :h] for w in ws[1:]] if upstream else [])
    ops = tiny_mma_operands(model, cfg)[:len(wants)]
    off = 0
    for (name, op), want in zip(ops, wants):
        K, N = want.shape
        assert torch.equal(op, want), name
        size = _pad32(K) * N
        if name.endswith(".fwd"):
            assert off == _fwd_off(cfg, int(name.split(".")[1])), name
        b = _unpack(flat[off:off + size], K, N)
        assert torch.equal(b[:K], want), name
        assert not bool(b[K:].any()), f"{name}: K padding is zero"
        off += size
    assert off == flat.numel()
    # One gather reproduces the packer applied operand by operand.
    assert torch.equal(flat, torch.cat([pack_mma_b(b) for _, b in ops]))


@pytest.mark.parametrize("hidden,num_freqs", [(32, 4), (128, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_packed_f32_buffer_is_the_explicit_layout(hidden, num_freqs, dtype):
    """pack_weights' gather equals the layout written out: per layer W (in,
    out) then b, the head W (hidden, 4) as r, g, b, sigma, its bias; weights
    rounded to the compute dtype, biases f32."""
    model, cfg = _model(hidden, num_freqs, dtype)

    def w(lin):
        return lin.weight.detach().to(dtype).float().t()

    parts = []
    for lin in model.layers:
        parts += [w(lin).reshape(-1), lin.bias.detach()]
    parts += [torch.cat([w(model.rgb[0]), w(model.sigma[0])], dim=1).reshape(-1),
              torch.cat([model.rgb[0].bias, model.sigma[0].bias]).detach()]
    assert torch.equal(pack_weights(model, cfg), torch.cat(parts))
    assert pack_tiny_weights(model, cfg)[1] is None


@pytest.mark.parametrize("hidden,num_freqs", WIDTHS)
@torch.no_grad()
def test_emulated_k1_forward_is_the_tinynerf_forward_and_the_jax_one(hidden, num_freqs):
    """K1's tensor-core trunk, emulated over its buffer at mma_fwd_off on
    128 bf16 rows: each layer gives the model's own pre-activation to
    float32 rounding; chained as the kernel chains them (bias, ReLU, bf16
    rounding, the skip concat) the heads give the TinyNeRF bf16 forward
    and apply_tinynerf on the same weights, within the bf16 render gates
    (tests/test_torch_port_kernel.py)."""
    model, cfg = _model(hidden, num_freqs, seed=1)
    _, buf = pack_tiny_weights(model, cfg, mma=True)
    rng = np.random.RandomState(hidden + num_freqs)
    x = rng.uniform(-1, 1, (128, cfg.in_dim)).astype(np.float32)
    enc = _round(torch.from_numpy(x))
    h = enc
    for i, lin in enumerate(model.layers):
        K, N = h.shape[1], lin.out_features
        off = _fwd_off(cfg, i)
        got = _emulate(h, buf[off:off + _pad32(K) * N], K, N) + lin.bias.double()
        want = dense(h, lin, BF).double()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6, i
        h = _round(torch.relu(got).float())
        if i == cfg.skip_at - 1:
            h = torch.cat([h, enc], dim=-1)
    rgb = torch.sigmoid(dense(h, model.rgb[0], BF))
    sigma = torch.relu(dense(h, model.sigma[0], BF))
    for want_rgb, want_sigma in (
        model(enc, cfg),
        map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), jmodel.apply_tinynerf(
            params_to_jax(model),
            jnp.asarray(x),
            jmodel.TinyNeRFConfig(in_dim=cfg.in_dim, hidden=hidden, compute_dtype=jnp.bfloat16))),
    ):
        err = torch.cat([(rgb - want_rgb).abs(), (sigma - want_sigma).abs()], dim=1).max(1).values
        assert float(torch.quantile(err, 0.999)) < 3e-2
        assert float(err.mean()) < 1e-3
        assert float((err > 3e-2).float().mean()) < 2.5e-3


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient to bf16, as K2 rounds
    each upstream gradient where it writes it."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _round(g)


@pytest.mark.parametrize("hidden,num_freqs", WIDTHS)
def test_emulated_k2_weight_and_upstream_gradients_are_autograds(hidden, num_freqs):
    """K2's tensor-core backward of one 64-point tile, emulated: per layer,
    last first, the weight gradient over the input rows and one row of ones
    (the skip layer's [act, enc] one segment, so its bias row is counted
    once) in the lanes' point order, and the upstream product over K2's
    buffer (after every forward operand), masked by act_{i-1} and rounded
    to bf16. Against autograd in float64 of the same rounded forward, with
    each upstream gradient rounded to bf16 (_RoundGrad)."""
    model, cfg = _model(hidden, num_freqs, seed=2)
    _, buf = pack_tiny_weights(model, cfg, mma=True, upstream=True)
    h_, depth, skip = cfg.hidden, cfg.depth, cfg.skip_at
    rng = np.random.RandomState(7 * hidden + num_freqs)
    enc = _round(torch.from_numpy(rng.uniform(-1, 1, (64, cfg.in_dim)))).double()
    ws = [_round(lin.weight.detach()).double().requires_grad_() for lin in model.layers]
    bs = [lin.bias.detach().double().requires_grad_() for lin in model.layers]
    # The forward as the kernel stores it (act_i rounded to bf16), in float64.
    ins, acts, h = [], [], enc
    for i in range(depth):
        ins.append(h)
        r = torch.relu(h @ ws[i].t() + bs[i])
        a = _RoundGrad.apply(_round(r.detach()) + (r - r.detach()))  # value rounded, ReLU's gradient
        acts.append(a)
        h = torch.cat([a, enc], dim=1) if i == skip - 1 else a
    g_out = _round(torch.from_numpy(rng.randn(64, h_))).double() * (acts[-1] > 0)
    grads = torch.autograd.grad((acts[-1] * g_out).sum(), ws + bs)
    # The emulation: G holds layer i's output gradient (masked by act_i).
    G = g_out
    up_off = _fwd_off(cfg, depth)
    for i in range(depth - 1, -1, -1):
        x = ins[i].detach()
        part = _emulate_weight_grad(x, G)
        assert part.shape == (layer_in_dims(cfg)[i] + 1, h_)
        for got, want in ((part[:-1].t(), grads[i]), (part[-1], grads[depth + i])):
            assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max()) + 1e-12, i
        if i == 0:
            break
        off = up_off + (i - 1) * h_ * h_
        up = _emulate(G, buf[off:off + h_ * h_], h_, h_)
        G = _round(up) * (acts[i - 1].detach() > 0)


@pytest.mark.parametrize("hidden,num_freqs", [(32, 4), (128, 10), (64, 2)])
def test_k2_partial_rows_have_an_even_stride_and_marked_padding(hidden, num_freqs):
    model, cfg = _model(hidden, num_freqs)
    n_grad = pack_weights(model, cfg).numel()
    row = partial_row(n_grad)
    assert row % 4 == 0 and n_grad < row <= n_grad + 4
    names = tuple(n for n, _ in model.named_parameters())
    dst = _scatter_index(names, cfg, torch.device("cpu"))
    assert dst.dtype == torch.int32 and dst.numel() == row
    assert int(dst[n_grad]) == n_grad  # the loss, after every gradient value
    assert bool((dst[n_grad + 1:] == -1).all())  # padding: skipped by the reduction
    assert torch.equal(dst[:n_grad].sort().values, torch.arange(n_grad, dtype=torch.int32))


@pytest.mark.parametrize("hidden,num_freqs,S,dtype,k1,k2", [
    (128, 10, 64, BF, True, True),            # the recipe: 2 rays a K1 tile, 1 a K2 tile
    (32, 4, 16, BF, True, True),
    (64, 10, 32, BF, True, True),
    (64, 10, 48, BF, True, False),            # K1 pads 96 points to 128; K2 tiles 48
    (128, 10, 128, BF, True, False),          # K2: 128-point tiles
    (128, 10, 192, BF, False, False),         # beyond one 128-row tile
    (48, 10, 64, BF, False, False),           # hidden not a multiple of 32
    (256, 10, 64, BF, True, True),            # K2's own shared-memory check decides
    (128, 10, 64, torch.float32, False, False),  # f32: the CUDA cores, the exactness reference
    (32, 4, 1, BF, True, True),
    (32, 4, 0, BF, False, False),
])
def test_route_rules_never_raise(hidden, num_freqs, S, dtype, k1, k2):
    cfg = TinyNeRFConfig(in_dim=encoding_dim(num_freqs), hidden=hidden, compute_dtype=dtype)
    assert k1_uses_tensor_cores(cfg, S) is k1
    assert k2_uses_tensor_cores(cfg, S) is k2


def _cpu_rays(n=8, seed=3):
    rng = np.random.RandomState(seed)
    ro = torch.from_numpy((rng.randn(n, 3) * 0.1 + [0, 0, 4]).astype(np.float32))
    rd = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    tgt = torch.from_numpy(rng.rand(n, 3).astype(np.float32))
    return ro, rd, tgt


@pytest.mark.parametrize("hidden,S", [(32, 16), (48, 16), (32, 48)])
def test_bf16_k1_and_k2_take_the_plain_versions_on_the_cpu(hidden, S):
    """bf16 K1 and K2 on CPU tensors, on and off the tensor cores' route:
    the plain versions' values, and neither .launches nor .mma_launches
    moves."""
    model, cfg = _model(hidden, 4, seed=4)
    ro, rd, tgt = _cpu_rays()
    fns = (fused_render_rays, fused_loss_grads)
    before = [(f.launches, f.mma_launches) for f in fns]
    kw = dict(n_samples=S, num_freqs=4)
    with torch.no_grad():
        got = [fused_render_rays(model, ro, rd, **kw)]
        want = [fused_render_rays_plain(model, ro, rd, **kw)]
    loss, grads = fused_loss_grads(model, ro, rd, tgt, 5, randomized=False, **kw)
    want_loss, want_grads = fused_loss_grads_plain(model, ro, rd, tgt, 5, randomized=False, **kw)
    got += [loss, *grads]
    want += [want_loss, *want_grads]
    assert [(f.launches, f.mma_launches) for f in fns] == before
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


def test_k2_upstream_operands_hold_the_cuda_cores_backward_weights():
    """K2's upstream fragments are the rows the CUDA-core kernel reads
    (pack_backward_weights: W[:, :hidden] of layers 1..depth-1), in bf16."""
    model, cfg = _model(64, 4, seed=5)
    ups = [b for name, b in tiny_mma_operands(model, cfg) if name.endswith(".up")]
    want = pack_backward_weights(model, cfg)
    assert torch.equal(torch.cat([b.float().reshape(-1) for b in ups]), want)
