"""K3-K7 at every NeRF width and sample count the JAX kernels take, on the
CPU.

The JAX NeRF kernels check only R % tile_r and S % sample_block: no rule
on the widths or on the sample count's factors. The port's kernels used
to refuse widths past 256 (blocks past 512 threads, or a forward buffer
past 227 KB of shared memory: F6) and walk tiles whose segment is no
whole number of 128-point chunks within 227 KB (S = 65, 100, unions 164;
F7), and the fine pass's block rule raised StopIteration where no
multiple of 8 divides the union (228). Here, on the CPU, where each
wrapper runs its kernel's plain version:

- the shape rule (nerf_shape): the recipes keep the one-round kernel, its
  tile and its bytes; every F6 and F7 shape gets a route (the general
  kernel, in shared memory or with X in device memory), and no shape
  raises; the byte and thread counts are the C formulas', and the
  parent's rule asked for more than 512 threads or 227 KB at each F6/F7
  shape;
- the block rule (default_sample_block) over every union from 2 to 600:
  the JAX package's block wherever its rule yields one, else a block of at
  least 8 (or the whole union);
- the wrappers of K4, K6, K7 and the hierarchical render (K3, K5) at those
  shapes against jax.grad of the JAX package's unfused pass and its
  render_rays_hierarchical (tinynerf_tpu/models/nerf.py:123), f32;
- the trainer at hidden 320 and at 100 samples a ray.

The kernels themselves are held to their plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py's phase 38.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.ops.encoding import positional_encoding as jenc
from tinynerf_tpu.ops.volume import volume_render as jvolume
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.kernels import fused_nerf_train
from tinynerf_tpu_torch.kernels.fused_nerf import (
    MAX_SMEM_BYTES,
    MAX_THREADS,
    default_sample_block,
    fused_render_rays_hierarchical,
    nerf_shape,
    render_smem_bytes,
    walk_smem_bytes,
)
from tinynerf_tpu_torch.kernels.fused_nerf_stream import fused_nerf_pass_grads_streamed
from tinynerf_tpu_torch.kernels.fused_nerf_train import fine_pass_route, fused_nerf_pass_grads
from tinynerf_tpu_torch.kernels.fused_partials import make_fused_block_partials_fn
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_state_to_jax
from tinynerf_tpu_torch.ops.volume import global_deltas
from tinynerf_tpu_torch.training import TrainSettings


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def cfg_of(hidden, rgb_hidden=64, dtype=torch.bfloat16):
    """The flagship's other fields (L 10, L_dir 4, depth 8, skip 4)."""
    return NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=dtype)


# 1. The shape rule.

# (tag, hidden, rgb_hidden, S, seg, walk bytes, render bytes) of the recipes:
# the one-round kernel, the parent's tile and bytes.
RECIPES = [
    ("--model nerf coarse", 128, 64, 64, 64, 106368, 101592),
    ("--model nerf fine (K4, union 128)", 128, 64, 128, 128, 106176, 101484),
    ("flagship fine (K6, block 64)", 256, 64, 192, 64, 171920, 167128),
    ("K7 shard 96, block 48", 256, 64, 96, 48, 186400, 171872),
    ("F3 hidden 48", 48, 64, 64, 64, 65408, 60632),
]


@pytest.mark.parametrize("tag,hidden,rgb_hidden,S,seg,walk_bytes,render_bytes", RECIPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recipes_keep_the_one_round_kernel(tag, hidden, rgb_hidden, S, seg, walk_bytes,
                                           render_bytes, dtype):
    cfg = cfg_of(hidden, rgb_hidden, dtype)
    w = nerf_shape(cfg, S, seg)
    assert (w.route, w.threads, w.rounds, w.smem_bytes) == ("shared", 2 * max(hidden, rgb_hidden),
                                                            1, walk_bytes)
    assert w.tile_rays == 128 // np.gcd(128, seg)
    r = nerf_shape(cfg, S, seg, walk=False)
    assert (r.route, r.smem_bytes) == ("shared", render_bytes) and r.fits(cfg)


# The F6 and F7 commands, bf16: (tag, hidden, rgb_hidden, S, seg, walk?, tile,
# threads, rounds, route, the parent's tile and the bytes it asked for
# there; the parent's K3 halved its tile to 1 and still asked 297,068 B at
# hidden 512).
F6_F7 = [
    ("train --hidden 320", 320, 64, 64, 64, True, 2, 512, 2, "general", 2, 204672),
    ("eval --hidden 320 (K3)", 320, 64, 64, 64, False, 2, 512, 2, "general", 2, 199896),
    ("--hidden 384 --rgb-hidden 96", 384, 96, 64, 64, True, 2, 512, 2, "spill", 2, 237440),
    ("--hidden 512 --rgb-hidden 128", 512, 128, 64, 64, True, 2, 512, 2, "spill", 2, 302976),
    ("--hidden 512 --rgb-hidden 128 (K3)", 512, 128, 64, 64, False, 2, 512, 2, "spill", 1,
     297068),
    ("--hidden 128 --rgb-hidden 320", 128, 320, 64, 64, True, 2, 512, 2, "general", 2, 172928),
    ("--n-samples 100", 128, 64, 100, 100, True, 16, 256, 1, "general", 32, 271872),
    ("--n-samples 100, union 164 (K4)", 128, 64, 164, 164, True, 8, 256, 1, "general", 32,
     378368),
    ("--hidden 256 --n-samples 100 --n-fine 128 (K6)", 256, 64, 228, 57, True, 16, 512, 1,
     "general", 128, 4 * (128 * 322 + 13 * 128 * 57 + 20 * 128 + 27 * 128 + 4 * 128)),
    ("S=65", 128, 64, 65, 65, True, 32, 256, 1, "general", 128, 556544),
]


@pytest.mark.parametrize(
    "tag,hidden,rgb_hidden,S,seg,walk,tile,threads,rounds,route,parent_tile,parent_bytes", F6_F7)
def test_every_f6_f7_shape_gets_a_route(tag, hidden, rgb_hidden, S, seg, walk, tile, threads,
                                        rounds, route, parent_tile, parent_bytes):
    cfg = cfg_of(hidden, rgb_hidden)
    shape = nerf_shape(cfg, S, seg, walk=walk)
    assert (shape.tile_rays, shape.threads, shape.rounds, shape.route) == (tile, threads, rounds,
                                                                           route)
    assert shape.fits(cfg) and shape.smem_bytes <= MAX_SMEM_BYTES and shape.threads <= MAX_THREADS
    # What the parent's one-round rule asked for, past 512 threads or 227 KB.
    got = (walk_smem_bytes(cfg, parent_tile, S, seg) if walk
           else render_smem_bytes(cfg, parent_tile, seg))
    assert got == parent_bytes
    assert got > MAX_SMEM_BYTES or 2 * max(hidden, rgb_hidden) > MAX_THREADS
    if shape.general and not shape.spill:
        # The halving stops at the largest tile that fits.
        more = (walk_smem_bytes(cfg, 2 * tile, S, seg, True) if walk
                else render_smem_bytes(cfg, 2 * tile, seg))
        assert 2 * tile > min(128 // int(np.gcd(128, seg)), threads) or more > MAX_SMEM_BYTES
    # Forced routes: the general kernel anywhere, the spill route anywhere.
    for forced in ("general", "spill"):
        f = nerf_shape(cfg, S, seg, walk=walk, route=forced)
        assert f.general and f.spill == (forced == "spill") and f.tile_rays >= 1


@pytest.mark.parametrize("hidden,rgb_hidden,S,seg", [
    (40, 24, 7, 7), (8, 8, 1000, 1000), (1024, 256, 64, 64), (4096, 64, 64, 64),
    (128, 64, 4000, 4000), (128, 64, 3, 3), (256, 64, 640, 128)])
@pytest.mark.parametrize("walk", [True, False])
def test_the_shape_rule_never_raises(hidden, rgb_hidden, S, seg, walk):
    """Odd widths and sample counts get a shape (wider than the tensor
    cores' 512 in bf16: the CUDA cores); a shape that fits no route says so
    (fits() False) instead of raising."""
    cfg = cfg_of(hidden, rgb_hidden)
    shape = nerf_shape(cfg, S, seg, walk=walk)
    assert shape.tile_rays >= 1 and 1 <= shape.threads <= max(MAX_THREADS, 2 * max(hidden, rgb_hidden))
    if shape.fits(cfg):
        assert shape.smem_bytes <= MAX_SMEM_BYTES
    assert nerf_shape(cfg, S, seg, walk=walk, route="no such route") == shape
    if hidden > 512:
        assert not fused_nerf_train.uses_tensor_cores(cfg)


# 2. The block rule.


def test_block_rule_is_total_and_keeps_the_jax_blocks():
    """Every union from 2 to 600: the JAX rule's block where it yields one
    (tinynerf_tpu/kernels/fused_nerf.py:332-337), else a divisor of at
    least 8 or the whole union; never StopIteration."""
    def jax_rule(s, cap):
        return next((b for b in range(min(cap, s), 0, -1)
                     if s % b == 0 and (b % 8 == 0 or b == s)), None)

    for s in range(2, 601):
        b = default_sample_block(s, 64)
        assert s % b == 0
        want = jax_rule(s, 64)
        if want is not None:
            assert b == want, s
        else:
            assert b >= 8 or b == s, s
    assert [default_sample_block(s, 64) for s in (128, 192, 512, 100, 129, 130, 164, 228, 131)] \
        == [64, 64, 64, 50, 43, 26, 41, 57, 131]


def test_fine_pass_route_streams_union_228_in_blocks_of_57():
    """The flagship at --n-samples 100 --n-fine 128: union 228 streams
    (114 MiB of activations) in blocks of 57, where the JAX rule raises."""
    s = TrainSettings(n_rand=2048, n_samples=100)
    assert fine_pass_route(s, cfg_of(256), 128) == 57
    with pytest.raises(StopIteration):
        next(b for b in range(64, 0, -1) if 228 % b == 0 and (b % 8 == 0 or b == 228))
    assert fine_pass_route(s, cfg_of(128), 64) is None  # union 164: 41 MiB, K4


# 3. The wrappers' plain versions against the JAX package.

# (tag, hidden, rgb_hidden, n_coarse, union, block): the widths at 64
# samples, the sample counts at hidden 128, and union 228 at the flagship.
PARITY = [
    ("hidden 320", 320, 64, 64, 192, 64),
    ("384/96", 384, 96, 64, 128, 64),
    ("512/128", 512, 128, 64, 128, 64),
    ("rgb_hidden 320", 128, 320, 64, 128, 64),
    ("S=65", 128, 64, 65, 130, 26),
    ("S=100, union 164", 128, 64, 100, 164, 41),
    ("union 228", 256, 64, 100, 228, 57),
]
N_RAYS = 4


def pair(hidden, rgb_hidden, seed=1):
    """The port's NeRF (seeded, f32; the init is the JAX package's) and the
    JAX {'coarse', 'fine'} tree holding the same weights."""
    jcfg = jnerf.NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=jnp.float32)
    tcfg = NeRFConfig(hidden=hidden, rgb_hidden=rgb_hidden, compute_dtype=torch.float32)
    model = NeRF(tcfg, generator=torch.Generator().manual_seed(seed))
    params = nerf_state_to_jax({n: p.detach() for n, p in model.named_parameters()})
    return params, jcfg, model, tcfg


def batch(R, S, seed):
    rng = np.random.RandomState(seed)
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)).astype(np.float32), axis=1)
    return ro, rd, rng.rand(R, 3).astype(np.float32), z


def jax_pass_loss(mlp, ro, rd, target, z, noise, cfg):
    """One unfused pass over depths z with pre-ReLU density noise
    (tests/test_fused_nerf_stream.py:37-52)."""
    R, S = z.shape
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    x = jenc(pts.reshape(-1, 3), num_freqs=cfg.num_freqs)
    vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    d_enc = jnp.repeat(jenc(vd, num_freqs=cfg.num_freqs_dir), S, axis=0)
    rgb, sig = jnerf.apply_nerf_mlp(mlp, x, d_enc, cfg, sigma_noise=noise.reshape(-1, 1))
    comp, _, _, _ = jvolume(rgb.reshape(R, S, 3), sig.reshape(R, S), z, rd, white_bkgd=True)
    return jnp.mean((comp - target) ** 2)


def close(got, want, rtol=3e-4):
    """Each leaf within rtol of its max (the JAX kernels' tolerance,
    tests/test_fused_nerf_train.py:48-77)."""
    flat_w, tw = jax.tree_util.tree_flatten(want)
    flat_g, tg = jax.tree_util.tree_flatten(got)
    assert str(tw) == str(tg)
    for w, g in zip(flat_w, flat_g):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-30), np.abs(w).max()


def to_jax(mlp, grads):
    tree = nerf_state_to_jax({f"{p}.{n}": g for p in ("coarse", "fine")
                              for (n, _), g in zip(mlp.named_parameters(), grads)})
    return tree["fine"]


@pytest.mark.parametrize("tag,hidden,rgb_hidden,n_coarse,union,block", PARITY)
def test_pass_wrappers_match_jax_grad_at_every_shape(tag, hidden, rgb_hidden, n_coarse, union,
                                                     block):
    """K4 (the union as its fine pass), K6 (in blocks of default_sample_block's
    block) and K7 (the union as one shard; the MSE of its partials through
    the autograd Function) against jax.value_and_grad of the unfused pass
    at the same depths and density noise: loss rel. 1e-5, each leaf 3e-4 of
    its max. The noise is the recipes' (--sigma-noise-std 1): without it
    these random MLPs' gradients are small and cancel, and at hidden 512
    XLA's and torch's f32 matmuls, which sum in other orders, alone put a
    leaf more than 3e-4 of its max apart."""
    params, jcfg, model, tcfg = pair(hidden, rgb_hidden)
    ro, rd, target, z = batch(N_RAYS, union, 3)
    noise = np.random.RandomState(5).randn(N_RAYS, union).astype(np.float32)
    assert default_sample_block(union, 64) == block
    # Op by op, as the port's plain versions run: the two then sum in the
    # same order and agree within 1e-5 of a leaf's max, where the f32
    # gradients themselves lie up to 4e-3 of it from float64 sums (hidden
    # 320) and XLA's fused program (jax.jit) sums in another order.
    ref_loss, ref = jax.value_and_grad(jax_pass_loss)(
        params["fine"], *map(jnp.asarray, (ro, rd, target, z, noise)), jcfg)
    ro_t, rd_t, tg_t, z_t, n_t = (torch.from_numpy(a) for a in (ro, rd, target, z, noise))
    runs = {
        "K4": fused_nerf_pass_grads(model.fine, ro_t, rd_t, tg_t, 0, z_t, randomized=False,
                                    cfg=tcfg, sigma_noise=n_t),
        "K6": fused_nerf_pass_grads_streamed(model.fine, ro_t, rd_t, tg_t, z_t, cfg=tcfg,
                                             sample_block=block, sigma_noise=n_t),
    }
    fn = make_fused_block_partials_fn(tcfg, sample_block=block)
    partials, _ = fn(model.fine, ro_t, rd_t, z_t, global_deltas(z_t, rd_t), n_t)
    comp = partials["C"] + (1.0 - partials["A"][:, None])
    loss7 = torch.mean((comp - tg_t) ** 2)
    runs["K7"] = (loss7.detach(), torch.autograd.grad(loss7, list(model.fine.parameters())))
    for name, (loss, grads) in runs.items():
        assert abs(float(loss) - float(ref_loss)) <= 1e-5 * float(ref_loss), name
        close(to_jax(model.fine, grads), ref)


@pytest.mark.parametrize("tag,hidden,rgb_hidden,n_coarse,union,block",
                         [PARITY[0], PARITY[2], PARITY[5], PARITY[6]])
def test_hierarchical_render_matches_jax_at_every_shape(tag, hidden, rgb_hidden, n_coarse,
                                                        union, block):
    """The deterministic coarse -> resample -> fine render (K3 both passes,
    or K3 then K5 where hidden x union passes 128 x 384: hidden 320, 512
    and the flagship's union 228 in blocks of 57) against
    render_rays_hierarchical(randomized=False), 1e-4."""
    params, jcfg, model, tcfg = pair(hidden, rgb_hidden)
    ro, rd, _, _ = batch(N_RAYS, 2, 4)
    jc, jf = jnerf.render_rays_hierarchical(params, jnp.asarray(ro), jnp.asarray(rd),
                                            n_coarse=n_coarse, n_fine=union - n_coarse,
                                            cfg=jcfg, randomized=False)
    with torch.no_grad():
        c, f = fused_render_rays_hierarchical(model, torch.from_numpy(ro), torch.from_numpy(rd),
                                              n_coarse=n_coarse, n_fine=union - n_coarse,
                                              cfg=tcfg)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-4)


# 4. The trainer.


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=4, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


@pytest.mark.parametrize("kw", [dict(hidden=320, n_samples=16, n_fine=16),
                                dict(hidden=128, n_samples=100, n_fine=64)])
def test_train_nerf_at_hidden_320_and_100_samples(tiny_npz, tmp_path, kw):
    """python -m tinynerf_tpu_torch.train --model nerf --hidden 320 (the
    general walk's width on the card) and --n-samples 100 (its tiles off
    whole chunks; union 164) on the fused route: the CPU runs K4's plain
    version every step, a finite held-out PSNR."""
    before = fused_nerf_train.fused_nerf_pass_grads.launches
    res = train.main(Config(data_path=tiny_npz, out_dir=str(tmp_path / "out"), device="cpu",
                            model="nerf", iters=2, n_rand=16, num_freqs=4, num_freqs_dir=2,
                            log_every=1, ckpt_path=str(tmp_path / "ckpt.npz"), resume=False,
                            holdout=1, chunk=256, **kw))
    assert np.isfinite(res["final_psnr"]) and np.isfinite(res["eval"]["psnr_mean"])
    assert fused_nerf_train.fused_nerf_pass_grads.launches == before  # no launch on the CPU
