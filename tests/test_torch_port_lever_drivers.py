"""The trainer's levers end to end on the CPU at a tiny size (eight 16x16
synthetic poses, the JAX tests' TINY NeRF widths): a full-NeRF run with
every lever on (pool draws, precrop, the sigma-noise and lr schedules,
AdamW, the EMA, the sparsity prior, a strided holdout, --eval-every,
--ckpt-keep) writes its checkpoint, its EMA twin, two rotated copies and
its held-out JSONL records, resumes like an uninterrupted run, and the
JAX package restores its checkpoint with the matching optimizer; a run
pinned at the background PSNR exits with code 3 after writing its
checkpoint and its sigma_death record; --eval-every needs --holdout; and
the sharded block with the sparsity prior on two gloo ranks keeps its
replicas bit-identical."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tinynerf_tpu import training as jtraining
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.utils import checkpoint as jax_ckpt
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_state_to_jax
from tinynerf_tpu_torch.ops.regularizers import make_sparsity_grad_fn
from tinynerf_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from tinynerf_tpu_torch.parallel.train import make_sharded_train_block
from tinynerf_tpu_torch.training import TrainSettings, exponential_lr, make_optimizer

TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
TINY_CFG = dict(num_freqs=4, num_freqs_dir=2, hidden=32, nerf_depth=3, nerf_skip_at=2,
                rgb_hidden=16)
LEVERS = dict(ray_sampling="pool", precrop_iters=3, sigma_noise_std=1.0,
              sigma_noise_decay_steps=4, sigma_noise_floor=0.1, lr_decay_steps=4, lr_floor=5e-5,
              weight_decay=1e-4, ema_decay=0.9, sigma_sparsity=1e-3, sigma_sparsity_points=64,
              holdout=2, holdout_mode="strided", eval_every=2, ckpt_keep=2)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=8, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def _cfg(tiny_npz, tmp_path, **kw):
    base = dict(model="nerf", data_path=tiny_npz, out_dir=str(tmp_path / "out"), device="cpu",
                iters=6, n_rand=32, n_samples=8, n_fine=8, log_every=1, preview_every=100,
                ckpt_every=2, ckpt_path=str(tmp_path / "ckpt.npz"), resume=False,
                metrics_path=str(tmp_path / "metrics.jsonl"), chunk=64, **TINY_CFG)
    base.update(kw)
    return Config(**base)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_nerf_run_with_every_lever(tiny_npz, tmp_path):
    cfg = _cfg(tiny_npz, tmp_path, **LEVERS)
    res = train.main(cfg)
    opt = res["optimizer"]
    ckpt = cfg.ckpt_path
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".ema.npz")
    assert sorted(f for f in os.listdir(tmp_path) if ".step" in f) == [
        "ckpt.npz.step00000004.npz", "ckpt.npz.step00000006.npz"]
    recs = _records(cfg.metrics_path)
    held = [r for r in recs if r.get("kind") == "held-out"]
    assert [r["step"] for r in held] == [2, 4, 6] and held[-1].get("final")
    assert all("eval_ema" in r for r in held)
    meta = json.loads(str(np.load(ckpt)["meta"]))["meta"]
    assert meta["holdout"] == {"count": 2, "mode": "strided", "indices": [0, 7]}

    # eval --ema --holdout-views scores the twin on the recorded poses; the
    # raw weights on those poses give the run's final held-out score.
    ev_kw = dict(ckpt_path=ckpt, data_path=tiny_npz, device="cpu", holdout_views=True, chunk=64,
                 n_samples=8)
    ev_ema = eval_mod.main(eval_mod.EvalConfig(out_dir=str(tmp_path / "ev_ema"), ema=True,
                                               **ev_kw))
    with open(tmp_path / "ev_ema" / "metrics.json") as f:
        assert json.load(f)["indices"] == [0, 7]
    assert abs(ev_ema["psnr_mean"] - res["eval_ema"]["psnr_mean"]) < 1e-4
    ev = eval_mod.main(eval_mod.EvalConfig(out_dir=str(tmp_path / "ev"), **ev_kw))
    assert abs(ev["psnr_mean"] - res["eval"]["psnr_mean"]) < 1e-4

    # The JAX package restores the checkpoint with its matching optimizer.
    jcfg = jnerf.NeRFConfig(**TINY)
    params = jnerf.init_nerf(jax.random.PRNGKey(0), jcfg)
    tx = jtraining.make_optimizer(cfg.lr, 4, 0.1, weight_decay=1e-4, lr_floor=5e-5,
                                  ema_decay=0.9)
    jp, st, step, _ = jax_ckpt.restore_checkpoint(ckpt, params, tx.init(params))
    assert step == 6
    model = res["model"]
    names = [n for n, _ in model.named_parameters()]
    want_ema = nerf_state_to_jax(dict(zip(names, opt.ema)))
    for got, want in ((jp, nerf_state_to_jax(model.state_dict())),
                      (jtraining.ema_params_from_opt_state(st), want_ema)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_lever_run_resumes_like_an_uninterrupted_run(tiny_npz, tmp_path):
    """6 steps and a resume to 8 (schedule, AdamW and EMA state restored)
    end bit-identical to 8 uninterrupted steps; the last step's lr is the
    schedule's at count 7."""
    whole = train.main(_cfg(tiny_npz, tmp_path / "whole", iters=8, **LEVERS))
    _ = train.main(_cfg(tiny_npz, tmp_path / "cut", iters=6, **LEVERS))
    resumed = train.main(_cfg(tiny_npz, tmp_path / "cut", iters=8, resume=True, **LEVERS))
    for a, b in zip(whole["model"].parameters(), resumed["model"].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(whole["optimizer"].ema, resumed["optimizer"].ema):
        assert torch.equal(a, b)
    opt = resumed["optimizer"]
    assert opt.count() == 8
    assert opt.param_groups[0]["lr"] == exponential_lr(5e-4, 7, 4, 0.1, 5e-5)


def test_pinned_run_exits_3_with_checkpoint_and_record(tiny_npz, tmp_path):
    """The watchdog is on by default: a margin of 100 dB pins every logged
    PSNR, so after two log points the run saves, logs and exits 3."""
    cfg = _cfg(tiny_npz, tmp_path, model="tinynerf", hidden=32, iters=10, death_grace=0,
               death_window=2, death_margin=100.0)
    assert Config().death_check
    with pytest.raises(SystemExit) as exc:
        train.main(cfg)
    assert exc.value.code == 3
    assert int(np.load(cfg.ckpt_path)["step"]) == 2
    death = [r for r in _records(cfg.metrics_path) if r.get("sigma_death")]
    assert len(death) == 1 and death[0]["step"] == 2 and death[0]["pinned_since"] == 1
    assert death[0]["bg_psnr"] < 60


def test_eval_every_requires_holdout(tiny_npz, tmp_path):
    with pytest.raises(ValueError, match="--eval-every > 0 requires --holdout"):
        train.main(_cfg(tiny_npz, tmp_path, eval_every=2))


def _run_with_prior(steps=3):
    import dataclasses

    from tinynerf_tpu_torch.ops.occupancy import default_aabb

    rng = np.random.RandomState(0)
    data = [torch.from_numpy(a) for a in (
        (rng.randn(3, 64, 3) * 0.1).astype(np.float32),
        (rng.randn(3, 64, 3) / np.sqrt(3)).astype(np.float32),
        rng.rand(3, 64, 3).astype(np.float32))]
    cfg = NeRFConfig(compute_dtype=torch.float32, **TINY)
    s = dataclasses.replace(TrainSettings(n_rand=64, n_samples=16, num_freqs=4),
                            ray_sampling="pool", sigma_noise_std=0.3, sigma_noise_decay_steps=2)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 5e-4, decay_steps=2, ema_decay=0.9)
    prior = make_sparsity_grad_fn(s, "nerf", nerf_cfg=cfg, lam=1e-1, n_points=64,
                                  aabb=default_aabb(1.0))
    block = make_sharded_train_block(s, steps, make_mesh(sample_parallel=2), nerf_cfg=cfg,
                                     n_fine=8, fused_kernels=True, extra_grad_fn=prior)
    block(model, opt, 3, 0, *data)
    return [p.detach().clone() for p in model.parameters()], [e.clone() for e in opt.ema]


def _worker(rank, world, init, out):
    torch.set_num_threads(1)
    assert initialize_distributed(init_method=init, world_size=world, rank=rank,
                                  device_type="cpu")
    with torch.enable_grad():
        torch.save(_run_with_prior(), os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def test_sharded_block_with_sparsity_prior_keeps_replicas_identical(tmp_path):
    """Two gloo ranks, sample axis 2, K7's plain versions, pool draws, the
    noise schedule, the lr schedule, the EMA and the prior: both ranks end
    with bit-identical parameters and EMA."""
    init = f"file://{tmp_path / 'store'}"
    ctx = mp.spawn(_worker, args=(2, init, str(tmp_path)), nprocs=2, join=False)
    deadline = time.time() + 300  # a hung collective fails the test, not the suite
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("2 ranks did not finish in 300 s")
    (p0, e0), (p1, e1) = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(p0 + e0, p1 + e1))
    init_params = list(NeRF(NeRFConfig(compute_dtype=torch.float32, **TINY),
                            generator=torch.Generator().manual_seed(0)).parameters())
    assert not all(torch.equal(a, b) for a, b in zip(p0, init_params))
