"""The port's drivers (main, make_gif) and their data path, on the CPU at
a tiny size: a synthetic npz of a few 16x16 poses made by the port's
synthetic.py stands in for the 106x100x100 dataset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tinynerf_tpu import synthetic as jsyn
from tinynerf_tpu_torch import main as main_mod
from tinynerf_tpu_torch import make_gif as gif_mod
from tinynerf_tpu_torch import synthetic
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.data import ensure_data
from tinynerf_tpu_torch.models.tinynerf import TinyNeRF
from tinynerf_tpu_torch.utils.checkpoint import save_params
from tinynerf_tpu_torch.utils.cli import cli

META = {"model": "tinynerf", "cfg": {"hidden": 128, "depth": 4, "skip_at": 2, "num_freqs": 10}}


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    d = synthetic.generate_synthetic_dataset(n_poses=3, h=16, w=16)
    path = str(tmp_path_factory.mktemp("data") / "tiny.npz")
    np.savez(path, **d)
    return path


def test_synthetic_scene_matches_jax():
    np.testing.assert_array_equal(synthetic.hemisphere_poses(5), jsyn.hemisphere_poses(5))
    pts = np.random.RandomState(0).uniform(-1, 1, (200, 3)).astype(np.float32)
    want_rgb, want_sigma = jsyn.field(jnp.asarray(pts))
    rgb, sigma = synthetic.field(torch.from_numpy(pts))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want_rgb), atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma), rtol=1e-5, atol=1e-4)
    pose = synthetic.hemisphere_poses(3)[1]
    want = jsyn.render_ground_truth(jnp.asarray(pose), n_samples=64, h=12, w=12)
    got = synthetic.render_ground_truth(torch.from_numpy(pose), n_samples=64, h=12, w=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ensure_data(tiny_npz, tmp_path):
    d = ensure_data(tiny_npz)
    assert not d["synthetic"] and d["images"].shape == (3, 16, 16, 3)
    assert d["images"].dtype == np.float32 and d["poses"].shape == (3, 4, 4)
    cached = ensure_data(str(tmp_path / "absent.npz"), synthetic_path=tiny_npz)
    assert cached["synthetic"] and np.array_equal(cached["images"], d["images"])
    with pytest.raises(FileNotFoundError):
        ensure_data(str(tmp_path / "absent.npz"), allow_synthetic=False)


def test_main_renders_preview(tiny_npz, tmp_path):
    """The default (fused) route agrees with --no-fused, the eager
    composition, within the bf16 render gates."""
    imgs = {}
    for fused in (True, False):
        out = tmp_path / f"fused_{fused}"
        imgs[fused] = main_mod.main(Config(data_path=tiny_npz, out_dir=str(out), device="cpu",
                                           fused=fused))
        png = np.asarray(Image.open(out / "preview.png"))
        assert png.shape == (16, 16, 3) and png.dtype == np.uint8
    assert imgs[True].shape == (16, 16, 3)
    assert np.isfinite(imgs[True]).all() and (imgs[True] >= 0).all() and (imgs[True] <= 1).all()
    err = np.abs(imgs[True] - imgs[False]).max(axis=-1)
    assert np.quantile(err, 0.999) < 3e-2 and err.mean() < 1e-3


def test_cli_flags():
    cfg = cli(Config, ["--no-fused", "--device", "cpu", "--chunk", "1024"])
    assert (cfg.fused, cfg.device, cfg.chunk) == (False, "cpu", 1024)
    assert cli(Config, []).fused is True


def test_make_gif_from_checkpoint(tiny_npz, tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    save_params(ckpt, TinyNeRF(generator=torch.Generator().manual_seed(0)), 3, META)
    out = tmp_path / "spiral.gif"
    frames = gif_mod.main(gif_mod.GifConfig(ckpt_path=ckpt, data_path=tiny_npz, out_path=str(out),
                                            n_frames=3, device="cpu"))
    assert frames.shape == (3, 16, 16, 3) and frames.dtype == np.uint8
    gif = Image.open(out)
    assert gif.n_frames == 3 and gif.size == (16, 16)
