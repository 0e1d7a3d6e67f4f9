"""On the card: the reference's jitter is the kernels' own, a sound run
at a small size is correct, and the control (the reference in float8 in
the program's place) fails each cell's limits. They skip without a CUDA
device."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from gpubench.core import cell, check, control
from gpubench.reference import philox

# Small enough for a test run, large enough for the cells' routes (the
# NeRF fine pass streams through K6 from 128 rays a tile).
CARD = {
    "nerf-paper.train": {"traffic": {"views_per_scene": 4, "size": 32, "rays_per_scene": 256,
                                     "block_steps": 4}},
    "tinynerf.train-8scenes": {"traffic": {"views_per_scene": 4, "size": 32,
                                           "rays_per_scene": 256, "block_steps": 4}},
    "nerf-paper.render": {"traffic": {"size": 64, "spiral_frames": 4},
                          "config": {"check_views": 2}},
    "tinynerf.render": {"traffic": {"size": 64, "spiral_frames": 4},
                        "config": {"check_views": 2}},
}


@pytest.mark.cuda
def test_reference_jitter_is_the_kernels(cuda_device):
    from tinynerf_tpu_torch.kernels import fused_train

    for seed in (0, 12345, 2**31 - 2):
        z = fused_train.jitter_probe(seed, 256, 64, 2.0, 6.0, 1, cuda_device).cpu().numpy()
        assert np.array_equal(z, philox.jitter_depths(seed, 256, 64, 2.0, 6.0))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CARD))
def test_sound_small_run_is_correct(cuda_device, workload):
    out = cell.run(cell.Options(workload, 2**31 + 3, 0.5, overrides=CARD[workload]), time.time())
    assert out["correct"], out["checks"]
    assert out["checks"]["launches_off_route"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CARD))
def test_control_fails_the_limits(cuda_device, workload):
    lim = check.limits(workload)
    got = control.read(workload, [5, 6, 7], cuda_device, CARD[workload])["control"]
    for seed, readings in got.items():
        assert any(lim[k] is not None and v > lim[k] for k, v in readings["fp8"].items()), (
            seed, readings)
    torch.cuda.empty_cache()
