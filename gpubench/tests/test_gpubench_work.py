"""The work counted for the rooflines and the MFUs, by hand."""

from __future__ import annotations

import json

import pytest

from gpubench.core import cell, work
from gpubench.reference import nerf, tinynerf


def config(name: str) -> dict:
    return json.loads((cell.BENCH / "configs" / f"{name}.json").read_text())


def test_nerf_macs_per_point():
    shapes = nerf.layer_shapes(config("nerf-paper"))
    # 63x256 + 6 x 256x256 + 319x256 + 256x1 + 283x128 + 128x3
    assert work.forward_macs(shapes) == 16128 + 6 * 65536 + 81664 + 256 + 36224 + 384 == 527872
    assert work.train_macs(shapes, 256) == 1547904
    assert work.n_params(shapes) == 530052
    shapes64 = nerf.layer_shapes(dict(config("nerf-paper"), rgb_hidden=64))
    assert work.forward_macs(shapes64) == 509568
    assert work.train_macs(shapes64, 256) == 1494720


def test_tinynerf_macs_per_point():
    shapes = tinynerf.layer_shapes(config("tinynerf"))
    assert work.forward_macs(shapes) == 8064 + 16384 + 24448 + 16384 + 128 + 384 == 65792
    assert work.train_macs(shapes, 128) == 181248
    assert work.n_params(shapes) == 66308


@pytest.mark.parametrize("workload, flops", [
    ("nerf-paper.train", 3.246e12), ("tinynerf.train-8scenes", 190.1e9),
    ("nerf-paper.render", 43.24e12), ("tinynerf.render", 1.347e12)])
def test_flops_per_step_and_view(workload, flops):
    _, cfg, traffic = cell.load_cell(workload)
    got = cell.system_of(cfg).unit_work(cfg, traffic, traffic["kind"])
    assert got["flops"] == pytest.approx(flops, rel=1e-3)
    kernels = got["kernels"]
    assert sum(f for items in kernels.values() for f, _ in items) == got["flops"]


def test_bound_takes_the_longer_side():
    assert work.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_idle_share_is_read_over_the_measured_window():
    """Device time a unit from the trace, over the untraced window's time a
    unit: the profiler's slower host does not read as idle."""
    from gpubench.core import readers

    ctx = {"kind": "train", "steps_per_unit": 50, "window": {"seconds": 10.0, "units": 10},
           "trace": {"units": 2, "busy_s": 1.8, "window_s": 3.0}}
    assert readers.idle_pct(ctx, "train") == pytest.approx(10.0)
    assert readers.idle_pct(ctx, "render") is None
