"""Fixtures of the benchmark's own tests (no JAX here)."""

from __future__ import annotations

import pytest
import torch

# The cells at sizes a CPU test run holds: the configurations' widths, a
# few rays, 16 x 16 views.
SMALL = {
    "nerf-paper.train": {"traffic": {"views_per_scene": 3, "size": 16, "rays_per_scene": 64,
                                     "block_steps": 4}},
    "tinynerf.train-8scenes": {"traffic": {"scenes": 2, "views_per_scene": 3, "size": 16,
                                           "rays_per_scene": 64, "block_steps": 4}},
    "nerf-paper.render": {"traffic": {"size": 16, "spiral_frames": 4},
                          "config": {"check_views": 2}},
    "tinynerf.render": {"traffic": {"size": 16, "spiral_frames": 4},
                        "config": {"check_views": 2}},
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")


def cpu_jitter(seed, n_rays, n_samples, near, far):
    """The stratified jitter of the training kernels' plain versions, which
    the port's wrappers run on CPU tensors: the kernels' bins, u from a
    torch.Generator seeded with the int32 seed (not the kernels' Philox)."""
    h = (far - near) / (n_samples - 1)
    s = torch.arange(n_samples, dtype=torch.float32)
    grid = near + h * s
    u = torch.rand((n_rays, n_samples), generator=torch.Generator().manual_seed(int(seed)),
                   dtype=torch.float32)
    lower = torch.where(s == 0, grid, grid - 0.5 * h)
    upper = torch.where(s == n_samples - 1, grid, grid + 0.5 * h)
    return (lower + (upper - lower) * u).numpy()


@pytest.fixture
def cpu_program(monkeypatch):
    """On the CPU the wrappers run the kernels' plain versions, whose jitter
    comes from torch's generator: the references follow that stream."""
    from gpubench.reference import nerf, tinynerf

    monkeypatch.setattr(nerf, "jitter_depths", cpu_jitter)
    monkeypatch.setattr(tinynerf, "jitter_depths", cpu_jitter)
    torch.set_num_threads(4)
