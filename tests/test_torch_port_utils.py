"""Port parity for the last utilities: utils/profiling.py's trace (and
train --profile-dir) and utils/torch_import.py (the reference .pth
import), against tinynerf_tpu/utils/torch_import.py, on the CPU (the
spans and counters of utils/profiling.py: tests/test_torch_port_spans.py).

- trace and `train --profile-dir` write a Chrome trace on the CPU;
- a .pth in the reference's schema, written here from the JAX package's
  params_to_torch_state_dict, imports into a port TinyNeRF whose f32
  render is within 2e-5 of the JAX render of the JAX package's
  params_from_torch_state_dict of the same file (the render-parity
  tolerance); the port's export round-trips; a pickled payload is refused
  unless allow_pickle=True.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinynerf_tpu.models.tinynerf import TinyNeRFConfig as JaxConfig
from tinynerf_tpu.render import render_rays as jax_render_rays
from tinynerf_tpu.training import TrainSettings as JaxSettings
from tinynerf_tpu.training import init_train_state as jax_init_train_state
from tinynerf_tpu.utils import torch_import as jimport
from tinynerf_tpu_torch import synthetic, train
from tinynerf_tpu_torch.config import Config
from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.render import render_rays
from tinynerf_tpu_torch.utils import profiling
from tinynerf_tpu_torch.utils.cli import cli
from tinynerf_tpu_torch.utils.torch_import import (
    import_torch_checkpoint,
    params_from_torch_state_dict,
    params_to_torch_state_dict,
)


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for each test, whatever an earlier test in this process
    left (tests/test_torch_parity.py turns it off globally)."""
    with torch.enable_grad():
        yield


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    out = tmp_path / "prof"
    with profiling.trace(str(out)) as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(out / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(None) as prof:  # off: no profiler, nothing written
        assert prof is None
    with profiling.trace("") as prof:
        assert prof is None


def test_train_profile_dir_writes_a_trace(tmp_path):
    d = synthetic.generate_synthetic_dataset(n_poses=3, h=16, w=16)
    data = str(tmp_path / "tiny.npz")
    np.savez(data, **d)
    argv = ["--device", "cpu", "--iters", "2", "--n-rand", "32", "--n-samples", "8",
            "--hidden", "32", "--num-freqs", "4", "--chunk", "256", "--no-resume",
            "--data-path", data, "--out-dir", str(tmp_path / "out"),
            "--ckpt-path", str(tmp_path / "ckpt.npz"), "--profile-dir", str(tmp_path / "prof")]
    cfg = cli(Config, argv)
    assert cfg.profile_dir == str(tmp_path / "prof") and Config().profile_dir is None
    train.main(cfg)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    assert len(json.load(open(tmp_path / "prof" / files[0]))["traceEvents"]) > 0


def _reference_pth(tmp_path, step=777):
    """A reference-schema .pth from the JAX package's exporter, f32 weights."""
    cfg = JaxConfig(compute_dtype=jnp.float32)
    params, _ = jax_init_train_state(jax.random.PRNGKey(11), JaxSettings(model_cfg=cfg))
    state = {k: torch.from_numpy(v) for k, v in jimport.params_to_torch_state_dict(params).items()}
    path = str(tmp_path / "ref_style.pth")
    torch.save({"model": state, "step": step, "in_dim": 63,
                "cfg": {"hidden": 128, "depth": 4, "skip_at": 2}}, path)
    return path, cfg


def test_reference_pth_imports_and_renders_as_the_jax_package(tmp_path):
    path, jcfg = _reference_pth(tmp_path)
    model, meta = import_torch_checkpoint(path, device="cpu", compute_dtype=torch.float32)
    assert meta == {"step": 777, "in_dim": 63, "cfg": {"hidden": 128, "depth": 4, "skip_at": 2}}
    assert model.cfg == TinyNeRFConfig(in_dim=63, hidden=128, depth=4, skip_at=2,
                                       compute_dtype=torch.float32)
    jparams, jmeta = jimport.import_torch_checkpoint(path)
    assert jmeta == meta
    rng = np.random.RandomState(4)
    ro = (rng.randn(50, 3) * 0.1).astype(np.float32)
    rd = rng.randn(50, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    want = np.asarray(jax_render_rays(jparams, jnp.asarray(ro), jnp.asarray(rd), n_samples=16,
                                      model_cfg=jcfg))
    with torch.no_grad():
        got = render_rays(model, torch.from_numpy(ro), torch.from_numpy(rd), n_samples=16).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_export_round_trips_and_takes_a_bare_state_dict(tmp_path):
    path, _ = _reference_pth(tmp_path)
    model, _ = import_torch_checkpoint(path, device="cpu")
    state = params_to_torch_state_dict(model)
    assert set(state) == set(model.state_dict()) and all(isinstance(v, np.ndarray)
                                                         for v in state.values())
    bare = str(tmp_path / "bare.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, bare)
    again, meta = import_torch_checkpoint(bare, device="cpu")
    assert meta["step"] == 0 and meta["in_dim"] == 63
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    loaded = params_from_torch_state_dict(state)
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="not a TinyNeRF state_dict"):
        params_from_torch_state_dict({"w": np.zeros(3)})


class _Payload:
    """A pickled object: what weights-only loading refuses."""


def test_a_pickled_payload_is_refused_unless_allowed(tmp_path):
    path, _ = _reference_pth(tmp_path)
    ckpt = torch.load(path, weights_only=True)
    ckpt["extra"] = _Payload()
    pickled = str(tmp_path / "pickled.pth")
    torch.save(ckpt, pickled, pickle_module=pickle)
    with pytest.raises(ValueError, match="allow_pickle=True"):
        import_torch_checkpoint(pickled, device="cpu")
    model, meta = import_torch_checkpoint(pickled, allow_pickle=True, device="cpu")
    assert meta["step"] == 777
