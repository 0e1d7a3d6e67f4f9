"""The readers of the program's own spans (core/program_spans.py and the
six metrics that use it) on fake totals and a fake traced window, and on
the recorder itself under a CPU profiler."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from gpubench.core import cell, program_spans
from tinynerf_tpu_torch.utils import profiling

TRAIN = ["host_draw_ms.train", "host_optimizer_ms.train", "host_wrappers_ms.train"]
RENDER = ["host_wrappers_ms.render", "host_pack_ms.render", "weight_repacks.render"]

# Totals as the recorder keeps them, by (name, parent): a traced window of
# 4 steps (train) or 2 views (render), seconds.
TOTALS = {"train": {
    ("step", None): (4, 0.4),
    ("step.draw", "step"): (4, 0.008),
    ("step.grad", "step"): (4, 0.2),
    ("step.optimizer", "step"): (4, 0.012),
    ("fused_nerf_pass_grads", "step.grad"): (4, 0.02),
    ("fused_nerf_pass_grads.pack", "fused_nerf_pass_grads"): (4, 0.004),
    ("fused_nerf_pass_grads.launch", "fused_nerf_pass_grads"): (4, 0.001),
    ("fused_nerf_pass_grads_streamed", "step.grad"): (4, 0.016),
    ("fused_nerf_pass_grads_streamed.pack", "fused_nerf_pass_grads_streamed"): (4, 0.002),
    ("fused_nerf_pass_grads_streamed.launch", "fused_nerf_pass_grads_streamed"): (4, 0.001),
}, "render": {
    ("view", None): (2, 0.8),
    ("view.chunk", "view"): (80, 0.7),
    ("fused_nerf_render_rays", "view.chunk"): (160, 0.3),
    ("fused_nerf_render_rays.pack", "fused_nerf_render_rays"): (160, 0.2),
    ("fused_nerf_render_rays.launch", "fused_nerf_render_rays"): (160, 0.01),
    ("weight_repacks", "fused_nerf_render_rays.pack"): (160, 0.0),
}}
# Per step: the draw 2 ms, the optimizer 3 ms, the wrappers (20 + 16) / 4 ms;
# per view: the wrapper 150 ms, its packing 100 ms, 80 repacks.
WANT = {"host_draw_ms.train": 2.0, "host_optimizer_ms.train": 3.0,
        "host_wrappers_ms.train": 9.0, "host_wrappers_ms.render": 150.0,
        "host_pack_ms.render": 100.0, "weight_repacks.render": 80.0}


def reader(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}", cell.BENCH / "metrics" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(kind, busy=1.0):
    return {"kind": kind, "steps_per_unit": 2 if kind == "train" else 1, "work": {},
            "window": {"seconds": 10.0, "units": 10},
            "trace": {"units": 2, "busy_s": busy, "window_s": 3.0}}


def fake_totals(monkeypatch, kind):
    monkeypatch.setattr(profiling, "spans", lambda: {
        k: {"count": c, "total_s": t, "self_s": t} for k, (c, t) in TOTALS[kind].items()})


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_each_reader_reads_its_totals_per_unit(monkeypatch, name):
    kind = name.rsplit(".", 1)[1]
    fake_totals(monkeypatch, kind)
    assert reader(name)(ctx(kind)) == pytest.approx(WANT[name])
    other = "render" if kind == "train" else "train"
    assert reader(name)(ctx(other)) is None


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_each_reader_reads_nothing_without_device_time(monkeypatch, name):
    kind = name.rsplit(".", 1)[1]
    fake_totals(monkeypatch, kind)
    assert reader(name)(ctx(kind, busy=0.0)) is None


@pytest.mark.parametrize("name", TRAIN + RENDER)
def test_each_reader_reads_nothing_from_a_program_without_the_recorder(monkeypatch, name):
    """The parent commit's program has no spans(): no number, no error."""
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.totals() is None
    assert reader(name)(ctx(name.rsplit(".", 1)[1])) is None


def test_a_window_without_steps_or_views_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: {})
    assert all(reader(n)(ctx(n.rsplit(".", 1)[1])) is None for n in TRAIN + RENDER)


def test_the_readers_take_the_recorders_own_totals():
    """A view recorded under a CPU profiler: one view, two chunks, one
    spanned wrapper a chunk whose second and later packs are repacks."""
    from torch.profiler import ProfilerActivity, profile

    from tinynerf_tpu_torch.render import chunked_over_rays

    layer = torch.nn.Linear(3, 3)

    def ray_fn(ro, rd):
        with profiling.span("wrapper"):
            with profiling.pack_span("wrapper.pack", layer):
                pass
            with profiling.span("wrapper.launch"):
                return layer(rd)

    pose = torch.eye(4)
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        chunked_over_rays(ray_fn, 16, 16, 16.0, pose, 128)
    c = ctx("render")
    c["trace"]["units"] = 1
    try:
        assert reader("weight_repacks.render")(c) == 1.0
        assert reader("host_pack_ms.render")(c) > 0
        assert reader("host_wrappers_ms.render")(c) >= reader("host_pack_ms.render")(c)
    finally:
        profiling.reset_spans()
