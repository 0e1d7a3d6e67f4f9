"""The port imports torch and never jax or tinynerf_tpu.

Checked in a fresh interpreter: this test process has already imported
jax (tests/conftest.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import sys
import tinynerf_tpu_torch.main, tinynerf_tpu_torch.make_gif
import tinynerf_tpu_torch.kernels.fused_render
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tinynerf_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax():
    # `python -c` puts the working directory, the repo root, on sys.path.
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
