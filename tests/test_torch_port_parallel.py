"""The port's data and sample parallelism on the CPU (gloo).

parallel/mesh.py's layouts, and parallel/train.py and parallel/render.py
over process groups of 2 and 4 CPU ranks (torch.multiprocessing.spawn
with a FileStore under tmp_path, so parallel test workers cannot collide
on a port), as tests/test_parallel.py and tests/test_fused_partials.py
hold the JAX package's meshes:
- sample meshes (1, 2) and (1, 4) equal (1, 1) after 3 steps, eager and
  with K7 (its plain versions on CPU tensors): params atol 1e-5, loss
  1e-6 (tests/test_parallel.py:142-169);
- K7 against the eager shard on one (1, 2) mesh, sigma-noise 0.3:
  params atol 2e-5 (tests/test_fused_partials.py:178-216);
- the TinyNeRF sharded loss on (1, 2) equals (1, 1) (:73-95);
- a (2, 2) mesh learns over 3 blocks and every rank's parameters are
  bit-identical (:172-193); data parallel with the K4 grad_fn learns;
- the sharded pass on given depths against the JAX package's
  single-device volume_render, 1e-5;
- the sharded renderer against the single-device one, 2e-5 (:127-139);
- `python -m torch.distributed.run ... train --data-parallel
  --sample-parallel 2 --fused-train` on 2 ranks, whose checkpoint (rank 0
  alone writes it) the JAX package restores; the trainer's flag checks.
The stochastic paths are compared within the port only: torch's draws
are not JAX's.

The spawned ranks import this module; it imports jax only inside the
tests that compare with the JAX package.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.ops.encoding import encoding_dim
from tinynerf_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SAMPLE_AXIS,
    all_reduce_sum,
    initialize_distributed,
    make_mesh,
    mesh_axes,
)
from tinynerf_tpu_torch.parallel.render import make_sharded_image_renderer
from tinynerf_tpu_torch.parallel.train import make_sharded_train_block, sharded_pass
from tinynerf_tpu_torch.render import make_image_renderer
from tinynerf_tpu_torch.training import TrainSettings, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = TrainSettings(n_rand=128, n_samples=16, num_freqs=4, lr=5e-4,
                      model_cfg=TinyNeRFConfig(in_dim=encoding_dim(4), hidden=32,
                                               compute_dtype=torch.float32))
TINY = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16,
                  compute_dtype=torch.float32)
NERF_S = TrainSettings(n_rand=64, n_samples=16, num_freqs=4, lr=5e-4)
RENDER = dict(H=20, W=20, focal=25.0, chunk=64, n_samples=16, num_freqs=4,
              model_cfg=SMALL.model_cfg)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def tiny_dataset(n_images=3, hw=64, seed=0):
    """tests/test_parallel.py:24-29."""
    rng = np.random.RandomState(seed)
    ro = (rng.randn(n_images, hw, 3) * 0.1).astype(np.float32)
    rd = rng.randn(n_images, hw, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    px = rng.rand(n_images, hw, 3).astype(np.float32)
    return [torch.from_numpy(a) for a in (ro, rd, px)]


def run_blocks(kind, mesh, *, steps=3, blocks=1, fused=False, noise=0.0, grad_fn=False):
    """Train from a seeded init on the mesh -> (params, per-block mean
    losses, last block's losses, the last step's mean-reduced gradients)."""
    import dataclasses

    data = tiny_dataset()
    if kind == "tiny":
        s = SMALL
        model = TinyNeRF(s.model_cfg, generator=torch.Generator().manual_seed(0))
        kw = {}
    else:
        s = dataclasses.replace(NERF_S, sigma_noise_std=noise)
        model = NeRF(TINY, generator=torch.Generator().manual_seed(0))
        if grad_fn:
            from tinynerf_tpu_torch.kernels.fused_nerf_train import make_fused_nerf_grad_fn

            kw = dict(grad_fn=make_fused_nerf_grad_fn(s, TINY, n_fine=8))
        else:
            kw = dict(nerf_cfg=TINY, n_fine=8, fused_kernels=fused)
    opt = make_optimizer(model.parameters(), s.lr)
    block = make_sharded_train_block(s, steps, mesh, **kw)
    means = []
    for b in range(blocks):
        m = block(model, opt, 3, b * steps, *data)
        means.append(float(m["loss"].mean()))
    return ([p.detach().clone() for p in model.parameters()], means, m["loss"].clone(),
            [p.grad.clone() for p in model.parameters()])


def given_depths_case():
    """A coarse MLP, rays and a fixed sorted z (R, 16) for the sharded pass."""
    rng = np.random.RandomState(7)
    R = 32
    ro = (rng.randn(R, 3) * 0.1).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (R, 16)).astype(np.float32), axis=1)
    model = NeRF(TINY, generator=torch.Generator().manual_seed(5))
    return model, *[torch.from_numpy(a) for a in (ro, rd, z)]


def _worker(rank, world, init, out, jobs):
    torch.set_num_threads(1)
    assert initialize_distributed(init_method=init, world_size=world, rank=rank,
                                  device_type="cpu")
    res = {}
    for job in jobs:
        res.update(globals()[job]())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def job_sample_mesh():
    """On any world: the whole world as the sample axis."""
    mesh = make_mesh(sample_parallel=dist.get_world_size())
    return {f"nerf_{fused}": run_blocks("nerf", mesh, fused=fused) for fused in (False, True)}


def job_world2():
    mesh = make_mesh(sample_parallel=2)
    res = {f"noise_{fused}": run_blocks("nerf", mesh, fused=fused, noise=0.3)
           for fused in (False, True)}
    res["tiny"] = run_blocks("tiny", mesh)
    model, ro, rd, z = given_depths_case()
    with torch.no_grad():
        for fused in (False, True):
            res[f"pass_{fused}"] = sharded_pass(model.coarse, ro, rd, z, mesh, TINY,
                                                need_weights=True, fused_kernels=fused)
    data_mesh = make_mesh()
    model = TinyNeRF(SMALL.model_cfg, generator=torch.Generator().manual_seed(0))
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    res["render"] = make_sharded_image_renderer(data_mesh, **RENDER)(model, pose)
    return res


def job_world4():
    mesh = make_mesh(sample_parallel=2)  # 2 x 2
    res = {"2x2": run_blocks("nerf", mesh, steps=20, blocks=3, fused=True)}
    res["dp_k4"] = run_blocks("nerf", make_mesh(), steps=20, blocks=3, grad_fn=True)
    return res


def spawn(tmp_path, world, jobs):
    out = tmp_path / f"world{world}"
    out.mkdir()
    init = f"file://{tmp_path / f'store{world}'}"
    ctx = mp.spawn(_worker, args=(world, init, str(out), jobs), nprocs=world, join=False)
    deadline = time.time() + 300  # a hung collective fails the test, not the suite
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in 300 s")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("p2"), 2, ["job_sample_mesh", "job_world2"])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("p4"), 4, ["job_sample_mesh", "job_world4"])


@pytest.fixture(scope="module")
def world1():
    """The (1, 1) runs, in this process: a world of one, no process group."""
    mesh = make_mesh()
    with torch.enable_grad():
        return {f"nerf_{fused}": run_blocks("nerf", mesh, fused=fused)
                for fused in (False, True)} | {"tiny": run_blocks("tiny", mesh)}


def _assert_same_run(a, b, atol):
    """Params within atol, losses within 1e-6, and the last step's
    gradients within 1e-3 of each leaf's max: Adam's step does not see a
    gradient's scale, so the parameters alone would not show a sharded
    gradient off by a constant factor."""
    for x, y in zip(a[0], b[0]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol)
    np.testing.assert_allclose(a[2].numpy(), b[2].numpy(), atol=1e-6)
    for x, y in zip(a[3], b[3]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-3 * float(y.abs().max()))


# 1. The mesh.


@pytest.mark.parametrize("n,sp,axes", [(8, 1, (8, 1)), (8, 2, (4, 2)), (4, 4, (1, 4)), (2, 1, (2, 1))])
def test_mesh_shapes_and_row_major_ranks(n, sp, axes):
    assert mesh_axes(make_mesh(n_devices=n, sample_parallel=sp)) == axes
    layout = np.arange(n).reshape(axes)  # np.reshape's device layout
    for r in range(n):
        m = make_mesh(n_devices=n, sample_parallel=sp, rank=r)
        assert layout[m.data_idx, m.sample_idx] == r
        assert (m.axis_index(DATA_AXIS), m.axis_index(SAMPLE_AXIS)) == (m.data_idx, m.sample_idx)
    assert make_mesh(n_devices=n, sample_parallel=sp).axis_names == (
        ("data",) if sp == 1 else ("data", "sample"))


def test_mesh_refuses_bad_layouts_and_runs_no_collective_without_a_group():
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(n_devices=6, sample_parallel=4)
    mesh = make_mesh(n_devices=4, sample_parallel=2)
    with pytest.raises(RuntimeError, match="no process group"):
        all_reduce_sum(torch.ones(3), mesh, SAMPLE_AXIS)
    one = make_mesh()
    x = torch.ones(3)
    assert all_reduce_sum(x, one, DATA_AXIS) is x  # an axis of one rank: no collective
    assert initialize_distributed(device_type="cpu") is False  # no launcher environment


def test_sharded_block_validates_like_the_jax_package():
    mesh = make_mesh(n_devices=2, sample_parallel=2)
    with pytest.raises(ValueError, match="nerf_cfg"):
        make_sharded_train_block(SMALL, 3, make_mesh(), fused_kernels=True)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_sharded_train_block(SMALL, 3, mesh, grad_fn=lambda *a: None)
    with pytest.raises(ValueError, match="data-parallel only"):
        make_sharded_train_block(SMALL, 3, mesh, loss=lambda *a: None)
    with pytest.raises(ValueError, match="not divisible by sample axis"):
        make_sharded_train_block(NERF_S, 3, mesh, nerf_cfg=TINY, n_fine=7)
    # The sparsity prior's extra_grad_fn is ported: the block takes it.
    assert callable(make_sharded_train_block(SMALL, 3, make_mesh(), extra_grad_fn=lambda *a: []))


# 2. Sample meshes equal (1, 1); K7 equals the eager shard.


@pytest.mark.parametrize("fused", [False, True])
def test_sample_mesh_1x2_equals_1x1(world2, world1, fused):
    for rank in world2:
        _assert_same_run(rank[f"nerf_{fused}"], world1[f"nerf_{fused}"], atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_sample_mesh_1x4_equals_1x1(world4, world1, fused):
    for rank in world4:
        _assert_same_run(rank[f"nerf_{fused}"], world1[f"nerf_{fused}"], atol=1e-5)


def test_fused_equals_eager_on_the_same_sample_mesh_with_noise(world2):
    eager, fused = world2[0]["noise_False"], world2[0]["noise_True"]
    for x, y in zip(eager[0], fused[0]):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-5)
    np.testing.assert_allclose(fused[2].numpy(), eager[2].numpy(), atol=1e-6)


def test_tinynerf_sharded_loss_1x2_equals_1x1(world2, world1):
    for rank in world2:
        _assert_same_run(rank["tiny"], world1["tiny"], atol=1e-5)


# 3. The 2-D mesh, data parallelism with the K4 grad_fn.


def test_2x2_mesh_learns_and_every_rank_holds_the_same_params(world4):
    params, means, _, _ = world4[0]["2x2"]
    assert np.isfinite(means).all() and means[-1] < means[0], means
    for rank in world4[1:]:
        assert all(torch.equal(a, b) for a, b in zip(params, rank["2x2"][0]))
        assert rank["2x2"][1] == means


def test_data_parallel_with_the_k4_grad_fn_learns(world4):
    params, means, _, _ = world4[0]["dp_k4"]
    assert np.isfinite(means).all() and means[-1] < means[0], means
    for rank in world4[1:]:
        assert all(torch.equal(a, b) for a, b in zip(params, rank["dp_k4"][0]))


# 4. Across packages, and the renderer.


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_pass_on_given_depths_matches_jax_volume_render(world2, fused):
    """Two ranks' sharded composite and global coarse weights on a fixed z
    equal the JAX package's single-device volume_render of the same MLP."""
    import jax.numpy as jnp

    from tinynerf_tpu.models import nerf as jnerf
    from tinynerf_tpu.ops.encoding import positional_encoding as jenc
    from tinynerf_tpu.ops.volume import volume_render
    from tinynerf_tpu_torch.models.nerf import nerf_params_to_jax

    model, ro, rd, z = given_depths_case()
    params = nerf_params_to_jax(model)["coarse"]
    jcfg = jnerf.NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2,
                            rgb_hidden=16, compute_dtype=jnp.float32)
    R, S = z.shape
    ro, rd, z = ro.numpy(), rd.numpy(), z.numpy()
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    d_enc = jnp.repeat(jenc(vd, num_freqs=2), S, axis=0)
    rgb, sig = jnerf.apply_nerf_mlp(params, jenc(pts.reshape(-1, 3), num_freqs=4), d_enc, jcfg)
    comp, _, _, weights = volume_render(rgb.reshape(R, S, 3), sig.reshape(R, S), z, rd)
    for rank in world2:
        got_comp, got_w = rank[f"pass_{fused}"]
        np.testing.assert_allclose(got_comp.numpy(), np.asarray(comp), atol=1e-5)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(weights), atol=1e-5)


def test_sharded_renderer_matches_single_device(world2):
    model = TinyNeRF(SMALL.model_cfg, generator=torch.Generator().manual_seed(0))
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    want = make_image_renderer(**RENDER)(model, pose)
    for rank in world2:
        np.testing.assert_allclose(rank["render"].numpy(), want.numpy(), atol=2e-5)


# 5. The trainer.


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    from tinynerf_tpu_torch import synthetic

    d = synthetic.generate_synthetic_dataset(n_poses=4, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def test_trainer_on_two_ranks_writes_a_checkpoint_jax_restores(tiny_npz, tmp_path):
    import jax
    import jax.numpy as jnp

    from tinynerf_tpu.models import nerf as jnerf
    from tinynerf_tpu.training import TrainSettings as JaxSettings
    from tinynerf_tpu.training import init_train_state
    from tinynerf_tpu.utils import checkpoint as jax_ckpt

    metrics = tmp_path / "metrics.jsonl"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
           "-m", "tinynerf_tpu_torch.train", "--model", "nerf", "--device", "cpu",
           "--data-parallel", "--sample-parallel", "2", "--fused-train", "--iters", "4",
           "--n-rand", "32", "--n-samples", "8", "--n-fine", "8", "--hidden", "32",
           "--nerf-depth", "3", "--nerf-skip-at", "2", "--num-freqs", "4", "--num-freqs-dir", "2",
           "--rgb-hidden", "16", "--log-every", "2", "--preview-every", "4", "--ckpt-every", "4",
           "--holdout", "1", "--chunk", "64", "--no-resume", "--data-path", tiny_npz,
           "--ckpt-path", str(tmp_path / "ckpt.npz"), "--out-dir", str(tmp_path / "out"),
           "--metrics-path", str(metrics)]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "[distributed] process 0/2, backend gloo" in out and "(K7) on the sample mesh" in out
    digests = {line.split()[-1] for line in out.splitlines() if "parameter digest" in line}
    assert out.count("parameter digest") == 2 and len(digests) == 1, out
    # Rank 0 alone writes: each log step once, then the final evaluation.
    recs = [json.loads(line) for line in open(metrics)]
    assert [r["step"] for r in recs] == [2, 4, 4] and recs[-1]["final"]
    assert sorted(os.listdir(tmp_path / "out")) == ["final.png", "preview_000004.png"]
    jcfg = jnerf.NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2,
                            rgb_hidden=16, compute_dtype=jnp.float32)
    params_t, opt_t = init_train_state(jax.random.PRNGKey(0), JaxSettings(),
                                       init_fn=lambda k: jnerf.init_nerf(k, jcfg))
    params, opt_state, step, meta = jax_ckpt.restore_checkpoint(str(tmp_path / "ckpt.npz"),
                                                                params_t, opt_t)
    assert step == 4 and meta["model"] == "nerf" and int(opt_state[0].count) == 4
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("kw,match", [
    (dict(sample_parallel=2), "requires --data-parallel"),
    (dict(sample_parallel=2, data_parallel=True), "needs more than one process"),
    (dict(sample_parallel=2, data_parallel=True, model="tinynerf"), "only implemented for --model nerf"),
])
def test_trainer_refuses_parallel_misconfigurations(tmp_path, kw, match):
    from tinynerf_tpu_torch import train

    cfg = Config(**{"model": "nerf", "device": "cpu", "out_dir": str(tmp_path), **kw})
    with pytest.raises(ValueError, match=match):
        train.main(cfg)
