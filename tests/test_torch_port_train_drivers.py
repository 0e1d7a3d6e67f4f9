"""The port's train and eval drivers on the CPU at a tiny size: a
synthetic npz of four 16x16 poses, hidden 32, L=4, 8 samples, 64 rays."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tinynerf_tpu import eval as jax_eval
from tinynerf_tpu_torch import eval as eval_mod
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.kernels import fused_train
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF, TinyNeRFConfig
from tinynerf_tpu_torch.utils import checkpoint
from tinynerf_tpu_torch.utils.cli import cli


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=4, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def _cfg(tiny_npz, tmp_path, **kw):
    base = dict(data_path=tiny_npz, out_dir=str(tmp_path / "out"), device="cpu", iters=6,
                n_rand=64, n_samples=8, hidden=32, num_freqs=4, log_every=2, preview_every=3,
                ckpt_every=3, ckpt_path=str(tmp_path / "ckpt.npz"), resume=False,
                metrics_path=str(tmp_path / "metrics.jsonl"), holdout=1, chunk=256)
    base.update(kw)
    return Config(**base)


def _params(path):
    model = TinyNeRF(TinyNeRFConfig(in_dim=27, hidden=32))
    checkpoint.restore_params(path, model)
    return [p.detach() for p in model.parameters()]


def test_train_eager_writes_checkpoint_png_and_jsonl(tiny_npz, tmp_path):
    cfg = _cfg(tiny_npz, tmp_path, fused_train=False)
    res = train.main(cfg)
    assert np.isfinite(res["final_psnr"]) and set(res["eval"]) >= {"psnr_mean", "ssim_mean"}
    png = np.asarray(Image.open(tmp_path / "out" / "final.png"))
    assert png.shape == (16, 16, 3)
    assert (tmp_path / "out" / "preview_000003.png").exists()
    recs = [json.loads(line) for line in open(cfg.metrics_path)]
    assert [r["step"] for r in recs[:3]] == [2, 4, 6] and recs[-1]["final"]
    assert recs[-1]["kind"] == "held-out"
    meta = checkpoint.read_meta(cfg.ckpt_path)
    assert meta["meta"]["holdout"] == {"count": 1, "mode": "tail", "indices": [3]}
    assert meta["meta"]["cfg"]["hidden"] == 32 and meta["n_opt"] == 1 + 2 * 12


def test_train_fused_route_takes_plain_version_on_cpu(tiny_npz, tmp_path, monkeypatch):
    calls = []
    plain = fused_train.fused_loss_grads_plain
    monkeypatch.setattr(fused_train, "fused_loss_grads_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = fused_train.fused_loss_grads.launches
    res = train.main(_cfg(tiny_npz, tmp_path, fused_train=True))
    assert len(calls) == 6 and fused_train.fused_loss_grads.launches == before
    assert np.isfinite(res["final_psnr"])


@pytest.mark.parametrize("fused_train", [True, False])
def test_resumed_run_equals_uninterrupted_run(tiny_npz, tmp_path, fused_train):
    full = _cfg(tiny_npz, tmp_path / "full", fused_train=fused_train, ckpt_every=100)
    train.main(full)
    part = _cfg(tiny_npz, tmp_path / "part", fused_train=fused_train, iters=3, ckpt_every=100)
    train.main(part)
    resumed = _cfg(tiny_npz, tmp_path / "part", fused_train=fused_train, resume=True,
                   ckpt_every=100)
    train.main(resumed)
    for a, b in zip(_params(full.ckpt_path), _params(resumed.ckpt_path)):
        assert torch.equal(a, b)


def test_eval_reads_port_checkpoint_in_both_packages(tiny_npz, tmp_path):
    cfg = _cfg(tiny_npz, tmp_path)
    train.main(cfg)
    out = tmp_path / "eval"
    res = eval_mod.main(eval_mod.EvalConfig(
        ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=str(out), holdout_views=True,
        save_error_maps=True, n_samples=8, device="cpu"))
    stored = json.load(open(out / "metrics.json"))
    assert stored["indices"] == [3] and stored["psnr_mean"] == res["psnr_mean"]
    assert (out / "view_003.png").exists() and (out / "err_003.png").exists()
    jres = jax_eval.main(jax_eval.EvalConfig(
        ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=str(tmp_path / "jax_eval"),
        holdout_views=True, n_samples=8, save_images=False))
    # Same weights and views; the port renders through its (plain) fused
    # route, the JAX package through XLA, both bf16.
    assert abs(jres["psnr_mean"] - res["psnr_mean"]) < 0.05
    # --save-depth (ported, ROADMAP item 10): both packages write the depth
    # and opacity maps of the same view, and they agree.
    maps = {}
    for pkg, run in (("port", lambda o: eval_mod.main(eval_mod.EvalConfig(
            ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=o, holdout_views=True,
            n_samples=8, save_images=False, save_depth=True, device="cpu"))),
                     ("jax", lambda o: jax_eval.main(jax_eval.EvalConfig(
            ckpt_path=cfg.ckpt_path, data_path=tiny_npz, out_dir=o, holdout_views=True,
            n_samples=8, save_images=False, save_depth=True)))):
        o = tmp_path / f"depth_{pkg}"
        run(str(o))
        maps[pkg] = [np.asarray(Image.open(o / f"{m}_003.png"), dtype=np.float32) / 255.0
                     for m in ("depth", "acc")]
    for a, b in zip(maps["port"], maps["jax"]):
        assert a.shape == b.shape == (16, 16, 3) and float(np.abs(a - b).mean()) < 0.02


def test_train_cli_flags():
    cfg = cli(Config, ["--no-fused-train", "--iters", "7", "--holdout", "4",
                       "--metrics-path", "m.jsonl", "--preview-pose", "None"])
    assert (cfg.fused_train, cfg.iters, cfg.holdout, cfg.metrics_path) == (False, 7, 4, "m.jsonl")
    assert cfg.preview_pose is None
    assert cli(Config, []).fused_train is True
    assert list(train._boundaries(0, 10, 4, 6)) == [(0, 4), (4, 2), (6, 2), (8, 2)]
    s = cli(Config, ["--sigma-noise-std", "0.5", "--no-bf16"]).train_settings()
    assert s.sigma_noise_std == 0.5 and s.model_cfg.compute_dtype == torch.float32
