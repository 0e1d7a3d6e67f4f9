"""The full NeRF's training checkpoints and driver on the CPU at a tiny
size: optax.adam's state for the {'coarse', 'fine'} tree crosses the
packages both ways, `python -m tinynerf_tpu_torch.train --model nerf`
runs end to end and resumes, the JAX package's trainer resumes the
port's checkpoint (and the port the JAX one), and both packages' eval
serve it. A synthetic npz of four 16x16 poses; the JAX tests' TINY
widths."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinynerf_tpu import eval as jax_eval
from tinynerf_tpu import train as jax_train
from tinynerf_tpu.config import Config as JaxConfig
from tinynerf_tpu.models import nerf as jnerf
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu.training import init_train_state as jax_init_train_state
from tinynerf_tpu.utils import checkpoint as jax_ckpt
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import make_gif, synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.kernels import fused_nerf_train
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig, nerf_params_to_jax, nerf_state_to_jax
from tinynerf_tpu_torch.training import make_optimizer
from tinynerf_tpu_torch.utils import checkpoint

TINY = dict(num_freqs=4, num_freqs_dir=2, hidden=32, depth=3, skip_at=2, rgb_hidden=16)
# The same model as Config fields (both packages' names).
TINY_CFG = dict(num_freqs=4, num_freqs_dir=2, hidden=32, nerf_depth=3, nerf_skip_at=2,
                rgb_hidden=16)


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=4, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def _cfg(tiny_npz, tmp_path, **kw):
    base = dict(model="nerf", data_path=tiny_npz, out_dir=str(tmp_path / "out"), device="cpu",
                iters=4, n_rand=32, n_samples=8, n_fine=8, log_every=2, preview_every=4,
                ckpt_every=4, ckpt_path=str(tmp_path / "ckpt.npz"), resume=False,
                metrics_path=str(tmp_path / "metrics.jsonl"), holdout=1, chunk=64, **TINY_CFG)
    base.update(kw)
    return Config(**base)


def _adam_state(model, opt):
    """Port Adam state -> (count, mu tree, nu tree) in the JAX layout."""
    named = dict(model.named_parameters())
    st = [opt.state[p] for p in named.values()]
    mu = nerf_state_to_jax({n: s["exp_avg"] for n, s in zip(named, st)})
    nu = nerf_state_to_jax({n: s["exp_avg_sq"] for n, s in zip(named, st)})
    return int(st[0]["step"]), mu, nu


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_port_training_checkpoint_restores_in_jax_with_adam_state(tmp_path):
    cfg = NeRFConfig(compute_dtype=torch.float32, **TINY)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model.parameters(), 5e-4)
    g = torch.Generator().manual_seed(2)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(path, model, opt, 3, {"model": "nerf"})
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **TINY)
    params_t, opt_t = jax_init_train_state(jax.random.PRNGKey(0), JaxSettings(),
                                           init_fn=lambda k: jnerf.init_nerf(k, jcfg))
    params, opt_state, step, meta = jax_ckpt.restore_checkpoint(path, params_t, opt_t)
    assert step == 3 and meta == {"model": "nerf"}
    count, mu, nu = _adam_state(model, opt)
    assert int(opt_state[0].count) == count == 3
    _leaves_equal(opt_state[0].mu, mu)
    _leaves_equal(opt_state[0].nu, nu)
    _leaves_equal(params, nerf_params_to_jax(model))


def test_jax_training_checkpoint_restores_in_port_with_adam_state(tmp_path):
    jcfg = jnerf.NeRFConfig(compute_dtype=jnp.float32, **TINY)
    params, opt_state = jax_init_train_state(jax.random.PRNGKey(4), JaxSettings(),
                                             init_fn=lambda k: jnerf.init_nerf(k, jcfg))
    tx = optax.adam(5e-4)
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, sub = jax.random.split(key)
        leaves, tdef = jax.tree_util.tree_flatten(params)
        subs = jax.random.split(sub, len(leaves))
        grads = tdef.unflatten([jax.random.normal(k, x.shape) for k, x in zip(subs, leaves)])
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, params, opt_state, 2, meta={"model": "nerf"})
    model = NeRF(NeRFConfig(compute_dtype=torch.float32, **TINY),
                 generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 5e-4)
    step, meta = checkpoint.restore_checkpoint(path, model, opt)
    assert step == 2 and meta == {"model": "nerf"}
    count, mu, nu = _adam_state(model, opt)
    assert count == int(opt_state[0].count) == 2
    _leaves_equal(opt_state[0].mu, mu)
    _leaves_equal(opt_state[0].nu, nu)
    _leaves_equal(params, nerf_params_to_jax(model))
    # A TinyNeRF optimizer structure is refused.
    info = checkpoint.read_meta(path)
    assert info["opt_struct"] == checkpoint.adam_struct(info["param_struct"])


@pytest.mark.parametrize("fused_train", [True, False])
def test_train_nerf_runs_writes_and_resumes_like_an_uninterrupted_run(tiny_npz, tmp_path,
                                                                      fused_train, capsys):
    full = _cfg(tiny_npz, tmp_path / "full", fused_train=fused_train, sigma_noise_std=0.5)
    res = train.main(full)
    assert np.isfinite(res["final_psnr"]) and isinstance(res["model"], NeRF)
    assert (tmp_path / "full" / "out" / "final.png").exists()
    assert (tmp_path / "full" / "out" / "preview_000004.png").exists()
    recs = [json.loads(line) for line in open(full.metrics_path)]
    assert [r["step"] for r in recs[:2]] == [2, 4] and recs[-1]["kind"] == "held-out"
    meta = checkpoint.read_meta(full.ckpt_path)
    assert meta["meta"]["model"] == "nerf" and meta["n_opt"] == 1 + 2 * meta["n_params"]
    assert meta["meta"]["cfg"] == {"hidden": 32, "depth": 3, "skip_at": 2, "num_freqs": 4,
                                   "num_freqs_dir": 2, "rgb_hidden": 16, "n_fine": 8,
                                   "ndc": False, "proposal": "coarse"}
    part = _cfg(tiny_npz, tmp_path / "part", fused_train=fused_train, sigma_noise_std=0.5,
                iters=2)
    train.main(part)
    capsys.readouterr()
    train.main(_cfg(tiny_npz, tmp_path / "part", fused_train=fused_train, sigma_noise_std=0.5,
                    resume=True))
    assert "[resume] loaded" in capsys.readouterr().out
    a, b = NeRF(NeRFConfig(**TINY)), NeRF(NeRFConfig(**TINY))
    checkpoint.restore_params(full.ckpt_path, a)
    checkpoint.restore_params(part.ckpt_path, b)
    for (n, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), n


def test_train_nerf_fused_route_takes_plain_versions_on_cpu(tiny_npz, tmp_path, monkeypatch):
    calls = []
    plain = fused_nerf_train.pass_grads_plain
    monkeypatch.setattr(fused_nerf_train, "pass_grads_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = fused_nerf_train.fused_nerf_pass_grads.launches
    train.main(_cfg(tiny_npz, tmp_path, iters=3))
    assert len(calls) == 2 * 3 and fused_nerf_train.fused_nerf_pass_grads.launches == before


def test_jax_trainer_resumes_port_checkpoint_and_back(tiny_npz, tmp_path, monkeypatch, capsys):
    """The JAX package's `train --model nerf` continues a port checkpoint,
    and the port continues the JAX one (optax.adam's state both ways)."""
    monkeypatch.chdir(tmp_path)  # the JAX driver's compilation cache
    kw = dict(model="nerf", data_path=tiny_npz, n_rand=32, n_samples=8, n_fine=8, log_every=2,
              preview_every=100, ckpt_every=100, holdout=1, chunk=64,
              ckpt_path=str(tmp_path / "x.npz"), **TINY_CFG)
    train.main(Config(**kw, iters=2, out_dir=str(tmp_path / "o1"), device="cpu", resume=False))
    capsys.readouterr()
    jax_train.main(JaxConfig(**kw, iters=4, out_dir=str(tmp_path / "o2"), death_check=False))
    assert "from step 2" in capsys.readouterr().out
    train.main(Config(**kw, iters=6, out_dir=str(tmp_path / "o1"), device="cpu"))
    assert "from step 4" in capsys.readouterr().out
    info = checkpoint.read_meta(str(tmp_path / "x.npz"))
    assert info["meta"]["model"] == "nerf"


def test_eval_and_make_gif_serve_port_nerf_checkpoint(tiny_npz, tmp_path):
    cfg = _cfg(tiny_npz, tmp_path, iters=2)
    train.main(cfg)
    res = eval_mod.main(eval_mod.EvalConfig(
        ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=str(tmp_path / "eval"),
        holdout_views=True, n_samples=8, device="cpu"))
    assert np.isfinite(res["psnr_mean"])
    jres = jax_eval.main(jax_eval.EvalConfig(
        ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=str(tmp_path / "jax_eval"),
        holdout_views=True, n_samples=8, save_images=False))
    # Same weights and views, bf16 on both sides.
    assert abs(jres["psnr_mean"] - res["psnr_mean"]) < 0.05
    frames = make_gif.main(make_gif.GifConfig(ckpt_path=cfg.ckpt_path, data_path=tiny_npz,
                                              out_path=str(tmp_path / "v.gif"), n_frames=2,
                                              n_samples=8, device="cpu"))
    assert frames.shape == (2, 16, 16, 3)
