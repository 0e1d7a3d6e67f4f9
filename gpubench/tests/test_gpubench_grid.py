"""The grid family's cell, instant-ngp.train, on the CPU: the files
parse; the work is the hand count; a run with the timed path broken
underneath comes out not correct; the new readers read nothing where
the program or the trace has nothing (a parent without the spans)."""

from __future__ import annotations

import importlib.util
import time

import pytest

from gpubench.core import cell
from gpubench.reference import grid as reference
from gpubench.systems import grid

SMALL = {
    "instant-ngp.train": {"config": {"n_levels": 4, "table_size": 1024, "max_res": 64,
                                     "n_samples": 16},
                          "traffic": {"views_per_scene": 3, "size": 16, "rays_per_scene": 256,
                                      "block_steps": 4}},
}


def test_the_configuration_and_the_mix_parse():
    c, cfg, traffic = cell.load_cell("instant-ngp.train")
    assert (c["config"], c["traffic"], c["chips"]) == ("instant-ngp", "train_image", 1)
    assert (cfg["family"], cfg["n_levels"], cfg["features"], cfg["table_size"], cfg["base_res"],
            cfg["max_res"], cfg["hidden"], cfg["density_outputs"]) == (
        "grid", 16, 2, 1 << 19, 16, 2048, 64, 16)
    assert (cfg["density_activation"], cfg["dir_encoding"], cfg["rgb_reads_density"]) == (
        "exp", "sh", True)
    assert (cfg["lr"], cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"], cfg["l2_reg"],
            cfg["sparse_adam"]) == (0.01, 0.9, 0.99, 1e-15, 1e-6, True)
    assert traffic["rays_per_scene"] * cfg["n_samples"] == cfg["batch_samples"] == 1 << 18
    assert cell.route_of(cfg, traffic) == {"all": [], "none": []}
    assert grid.KERNELS["train"] == ()
    assert (traffic["scenes"], traffic["views_per_scene"], traffic["size"]) == (1, 106, 400)


def test_the_work_is_the_hand_count():
    """Per point the MLPs' MACs: 32x64 + 64x16 (density), 32x64 + 64x64 +
    64x3 (colour on 16 + 16 SH) = 9,408; 5 dense levels (17^3, 23^3, 32^3,
    43^3, 59^3 = 334,734 entries) and 11 hashed of 2^19: 6,101,902 entries,
    12,203,804 table parameters and 9,619 of the MLPs; a pass of the
    encoding moves 2^18 points x 3 floats, the tables and 2^18 x 32
    features: 21,378,844 floats."""
    _, cfg, traffic = cell.load_cell("instant-ngp.train")
    assert reference.macs_per_point(cfg) == 2048 + 1024 + 2048 + 4096 + 192 == 9408
    assert reference.level_resolutions(cfg)[:6] == [16, 22, 31, 42, 58, 81]
    assert sum(reference.table_sizes(cfg)) == 334_734 + 11 * (1 << 19) == 6_101_902
    assert reference.n_params(cfg) == 12_203_804 + 9_619 == 12_213_423
    work = grid.unit_work(cfg, traffic, "train")
    assert work["flops"] == 2 * 3 * 9408 * (1 << 18)
    fwd = work["kernels"]["grid_encode"]
    assert fwd == work["kernels"]["grid_encode_bwd"]
    assert fwd[0][1] == 4 * (3 * (1 << 18) + 12_203_804 + 32 * (1 << 18)) == 85_515_376
    assert fwd[0][0] == 2 * 8 * 32 * (1 << 18)


def one(workload, fault=""):
    return cell.run(cell.Options(workload, 2**31 + 77, 0.2, device="cpu", fault=fault,
                                 overrides=SMALL[workload]), time.time())


@pytest.mark.parametrize("workload, fault", [(w, f) for w in SMALL
                                             for f in ("frozen", "half_batch", "altered")])
def test_a_planted_fault_is_not_correct(workload, fault):
    sound = one(workload)["checks"]
    broken = one(workload, fault)
    assert broken["correct"] is False
    worse = [k for k, c in broken["checks"].items() if c["limit"] is not None
             and c["value"] > c["limit"] and c["value"] > 3 * sound[k]["value"]]
    assert worse, broken["checks"]


def reader(name):
    path = cell.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_encode_readers_read_the_trace_and_nothing_else():
    _, cfg, traffic = cell.load_cell("instant-ngp.train")
    work = grid.unit_work(cfg, traffic, "train")
    trace = {"units": 2, "window_s": 1.0, "busy_s": 0.9,
             "kernel_s": {"grid_encode": 0.004, "grid_encode_bwd": 0.006}}
    ctx = {"kind": "train", "trace": trace, "work": work, "steps_per_unit": 50,
           "window": {"seconds": 30.0, "units": 20}}
    bound = 2 * work["kernels"]["grid_encode"][0][1] / 3.35e12
    assert reader("grid_encode_roofline")(ctx) == pytest.approx(100 * 100 * bound / 0.01)
    assert reader("grid_encode_ms.train")(ctx) == pytest.approx(1e3 * 0.01 / 100)
    for missing in ({}, {"grid_encode": 0.004}):
        bare = dict(ctx, trace=dict(trace, kernel_s=missing))
        assert reader("grid_encode_roofline")(bare) is None
        assert reader("grid_encode_ms.train")(bare) is None
    assert reader("grid_encode_roofline")(dict(ctx, kind="render")) is None
    # no program spans recorded (or a program without them): nothing read
    from tinynerf_tpu_torch.utils import profiling

    profiling.reset_spans()
    assert reader("host_encode_ms.train")(ctx) is None
