"""The port imports torch and never jax or tinynerf_tpu.

Checked in a fresh interpreter: this test process has already imported
jax (tests/conftest.py)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import sys
import tinynerf_tpu_torch.main, tinynerf_tpu_torch.make_gif
import tinynerf_tpu_torch.kernels.fused_render
import tinynerf_tpu_torch.train, tinynerf_tpu_torch.eval
import tinynerf_tpu_torch.kernels.fused_train
import tinynerf_tpu_torch.kernels.fused_nerf, tinynerf_tpu_torch.kernels.fused_nerf_stream
import tinynerf_tpu_torch.models.nerf, tinynerf_tpu_torch.utils.model_io
import tinynerf_tpu_torch.kernels.fused_nerf_train, tinynerf_tpu_torch.training
import tinynerf_tpu_torch.utils.checkpoint, tinynerf_tpu_torch.config
import tinynerf_tpu_torch.kernels.fused_partials
import tinynerf_tpu_torch.parallel.mesh, tinynerf_tpu_torch.parallel.train
import tinynerf_tpu_torch.parallel.render
import tinynerf_tpu_torch.ops.regularizers, tinynerf_tpu_torch.ops.occupancy
import tinynerf_tpu_torch.render, tinynerf_tpu_torch.synthetic, tinynerf_tpu_torch.ops.rays
import tinynerf_tpu_torch.models.grid_nerf
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tinynerf_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    # `python -c` puts the working directory, the repo root, on sys.path.
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The modules of the bf16 tensor-core wrappers (K1 and K2 and their
# packer, K3 and the packer, K4, K5, K6, K7), the trainer that reports
# its launch counts, the sparsity prior, the occupancy proposal, the grid
# family and the synthetic scenes, each alone in a fresh interpreter.
ALONE = """
import sys
import {module}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tinynerf_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("module", [
    "tinynerf_tpu_torch.kernels.fused_render",
    "tinynerf_tpu_torch.kernels.fused_train",
    "tinynerf_tpu_torch.kernels.fused_nerf",
    "tinynerf_tpu_torch.kernels.fused_nerf_train",
    "tinynerf_tpu_torch.kernels.fused_nerf_stream",
    "tinynerf_tpu_torch.kernels.fused_partials",
    "tinynerf_tpu_torch.train",
    "tinynerf_tpu_torch.ops.regularizers",
    "tinynerf_tpu_torch.ops.occupancy",
    "tinynerf_tpu_torch.models.grid_nerf",
    "tinynerf_tpu_torch.synthetic",
])
def test_tensor_core_wrappers_alone_never_import_jax(module):
    proc = subprocess.run([sys.executable, "-c", ALONE.format(module=module)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
