"""The port's spans and counters (utils/profiling.py), on the CPU, no JAX:

- off (no profiler recording), `span` is the shared no-op and nothing is
  recorded;
- on, under a CPU torch.profiler: totals by (name, parent), with self time
  = total - children on a fake perf_counter_ns; a span is an event of the
  profiler's timeline that holds its child aten ops (one clock); the
  schedule's warm-up step records nothing;
- the layer boundaries: each step loop records step, step.draw,
  step.grad and step.optimizer once a step; chunked_over_rays one view,
  its rays and one view.chunk a chunk; the hierarchical renderer's
  sample_pdf;
- the repack counter counts a pack of unchanged weights and not one after
  an update in place; the wrappers keep their launch counters.
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from tinynerf_tpu_torch import multiscene, render, training
from tinynerf_tpu_torch.kernels import (
    fused_nerf,
    fused_nerf_stream,
    fused_nerf_train,
    fused_partials,
    fused_render,
    fused_train,
)
from tinynerf_tpu_torch.models.nerf import NeRF, NeRFConfig
from tinynerf_tpu_torch.models.tinynerf import TinyNeRFConfig
from tinynerf_tpu_torch.parallel.mesh import make_mesh
from tinynerf_tpu_torch.parallel.train import make_sharded_train_block
from tinynerf_tpu_torch.utils import profiling

SMALL = TinyNeRFConfig(in_dim=3 + 6 * 4, hidden=32, depth=4, skip_at=2,
                       compute_dtype=torch.float32)


@pytest.fixture(autouse=True)
def _clean():
    """Autograd on (tests/test_torch_parity.py turns it off for its worker)
    and empty totals before and after each test."""
    profiling.reset_spans()
    with torch.enable_grad():
        yield
    profiling.reset_spans()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def counts(name: str) -> int:
    return sum(v["count"] for (n, _), v in profiling.spans().items() if n == name)


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("step"), profiling.span("view")
    assert a is b
    with a:
        with profiling.span("step.draw"):
            torch.ones(3).sum()
    profiling.count("weight_repacks")
    with profiling.pack_span("x.pack", torch.nn.Linear(2, 2)) as s:
        assert s is None
    assert profiling.spans() == {}


def test_on_totals_nest_by_parent_with_self_time(monkeypatch):
    ticks = iter([0, 10, 15, 40, 50, 100, 130, 170])  # ns at each span's start and end, in order
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    with recording():
        with profiling.span("step"):  # 0 .. 100
            with profiling.span("step.draw"):  # 10 .. 15
                pass
            with profiling.span("step.grad"):  # 40 .. 50
                profiling.count("weight_repacks", 2)
        with profiling.span("view"):  # 130 .. 170
            pass
    got = profiling.spans()
    assert got[("step", None)] == {"count": 1, "total_s": pytest.approx(100e-9),
                                   "self_s": pytest.approx(85e-9)}
    assert got[("step.draw", "step")]["total_s"] == pytest.approx(5e-9)
    assert got[("step.grad", "step")]["self_s"] == pytest.approx(10e-9)
    assert got[("weight_repacks", "step.grad")] == {"count": 2, "total_s": 0.0, "self_s": 0.0}
    assert got[("view", None)] == {"count": 1, "total_s": pytest.approx(40e-9),
                                   "self_s": pytest.approx(40e-9)}
    profiling.reset_spans()
    assert profiling.spans() == {}


def test_a_span_holds_its_child_ops_on_the_profilers_clock():
    with recording() as prof:
        with profiling.span("view.chunk"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    events = prof.events()
    outer = [e for e in events if e.name == "view.chunk"]
    inner = [e for e in events if e.name == "aten::mm"]
    assert len(outer) == 1 and inner
    for e in inner:
        assert outer[0].time_range.start <= e.time_range.start
        assert e.time_range.end <= outer[0].time_range.end
    assert counts("view.chunk") == 1


def test_the_schedules_warm_up_step_records_nothing():
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(3):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            with profiling.span("step"):
                torch.ones(4).sum()
            prof.step()
    assert seen == [False, True, True] and counts("step") == 2
    assert sum(1 for e in prof.events() if e.name == "step") == 2


def _scene(n_images=3, hw=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(n_images, hw, 3, generator=g) * 0.1
    rd = torch.nn.functional.normalize(torch.randn(n_images, hw, 3, generator=g), dim=-1)
    return ro, rd, torch.rand(n_images, hw, 3, generator=g)


def _block(loop: str):
    s = training.TrainSettings(n_rand=32, n_samples=8, num_freqs=4, model_cfg=SMALL)
    if loop == "multiscene":
        model, opt = multiscene.init_multiscene_state(0, 2, s)
        block = multiscene.make_multiscene_train_block(s, 3, 2)
        data = [torch.stack(t) for t in zip(_scene(seed=1), _scene(seed=2))]
        return block, model, opt, data
    model, opt = training.init_train_state(torch.Generator().manual_seed(0), s)
    if loop == "sharded":
        block = make_sharded_train_block(s, 3, make_mesh(1))
    else:
        block = training.make_train_block(s, 3)
    return block, model, opt, list(_scene())


@pytest.mark.parametrize("loop", ["single", "multiscene", "sharded"])
def test_a_3_step_block_records_each_part_of_each_step(loop):
    block, model, opt, data = _block(loop)
    with recording():
        block(model, opt, 5, 0, *data)
    got = profiling.spans()
    assert got[("step", None)]["count"] == 3
    for part in ("step.draw", "step.grad", "step.optimizer"):
        assert got[(part, "step")]["count"] == 3
    assert all(p.grad is not None for p in model.parameters())  # the last step's
    assert got[("step", None)]["self_s"] >= 0


def test_the_step_matches_an_untraced_step():
    """The spans change nothing: the same block, traced and not, leaves the
    same weights."""
    outs = []
    for traced in (False, True):
        block, model, opt, data = _block("single")
        if traced:
            with recording():
                block(model, opt, 5, 0, *data)
        else:
            block(model, opt, 5, 0, *data)
        outs.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_chunked_over_rays_records_one_view_and_each_chunk():
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    n_calls = []

    def ray_fn(ro, rd):
        n_calls.append(ro.shape[0])
        return torch.zeros(ro.shape[0], 3)

    with recording():
        img = render.chunked_over_rays(ray_fn, 20, 20, 20.0, pose, 128)
    assert img.shape == (20, 20, 3) and len(n_calls) == 4  # 400 rays in chunks of 128
    got = profiling.spans()
    assert got[("view", None)]["count"] == 1
    assert got[("view.rays", "view")]["count"] == 1
    assert got[("view.chunk", "view")]["count"] == 4


def test_the_hierarchical_render_records_sample_pdf_in_each_chunk():
    cfg = NeRFConfig(num_freqs=4, num_freqs_dir=2, hidden=32, depth=4, skip_at=2,
                     rgb_hidden=16, compute_dtype=torch.float32)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0))
    fn = render.make_hierarchical_image_renderer(H=8, W=8, focal=8.0, chunk=32, n_coarse=8,
                                                 n_fine=8, nerf_cfg=cfg, use_fused=True)
    pose = torch.eye(4)
    pose[2, 3] = 4.0
    with recording():
        fn(model, pose)
    got = profiling.spans()
    assert got[("view.chunk", "view")]["count"] == 2
    assert counts("sample_pdf") == 2
    assert counts("fused_nerf_render_rays") == 4  # coarse and fine, CPU plain path


def test_the_repack_counter_counts_unchanged_weights_only():
    a, b = torch.nn.Linear(3, 4), torch.nn.Linear(3, 4)
    profiling.pack_span("w.pack", a)  # off: the versions are kept all the same
    with recording():
        with profiling.pack_span("w.pack", a):  # unchanged since the pack before: a repack
            pass
        with profiling.pack_span("w.pack", b):  # b's first pack
            pass
        with torch.no_grad():
            a.weight.add_(1.0)  # an update in place
        with profiling.pack_span("w.pack", a):
            pass
        with profiling.pack_span("w.pack", a):  # again at the same versions
            pass
        with profiling.pack_span("other.pack", a):  # another buffer's first pack
            pass
    got = profiling.spans()
    assert got[("w.pack", None)]["count"] == 4
    assert got[("weight_repacks", "w.pack")]["count"] == 2
    assert ("weight_repacks", "other.pack") not in got


@pytest.mark.parametrize("module, name, counted_by", [
    (fused_render, "fused_render_rays", "fused_render_rays"),
    (fused_train, "fused_loss_grads", "fused_loss_grads"),
    (fused_train, "fused_loss_grads_scenes", "fused_loss_grads"),
    (fused_nerf, "fused_nerf_render_rays", "fused_nerf_render_rays"),
    (fused_nerf_stream, "fused_nerf_render_rays_streamed", "fused_nerf_render_rays_streamed"),
    (fused_nerf_train, "fused_nerf_pass_grads", "fused_nerf_pass_grads"),
    (fused_nerf_train, "fused_nerf_pass_grads_scenes", "fused_nerf_pass_grads"),
    (fused_nerf_stream, "fused_nerf_pass_grads_streamed", "fused_nerf_pass_grads_streamed"),
    (fused_nerf_stream, "fused_nerf_pass_grads_streamed_scenes",
     "fused_nerf_pass_grads_streamed"),
    (fused_partials, "fused_block_partials_fwd", "fused_block_partials_fwd"),
    (fused_partials, "fused_block_partials_bwd", "fused_block_partials_bwd"),
])
def test_each_wrapper_is_spanned_under_its_name_and_keeps_its_counters(module, name,
                                                                       counted_by):
    fn = getattr(module, name)
    assert fn.__name__ == fn.__wrapped__.__name__ == name
    holder = getattr(module, counted_by)
    assert all(isinstance(getattr(holder, c), int) for c in ("launches", "mma_launches"))


def test_the_chrome_trace_holds_the_programs_spans(tmp_path):
    import json
    import os

    block, model, opt, data = _block("single")
    with profiling.trace(str(tmp_path)):
        block(model, opt, 5, 0, *data)
    (name,) = os.listdir(tmp_path)
    names = {e.get("name") for e in json.load(open(tmp_path / name))["traceEvents"]}
    assert {"step", "step.draw", "step.grad", "step.optimizer"} <= names
