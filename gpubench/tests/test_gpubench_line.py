"""The run's refusals and its result line, driven on the CPU (the
kernels' plain versions) at the small sizes of conftest.SMALL."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest

from gpubench import run
from gpubench.core import cell

from .conftest import SMALL


def test_refuses_without_a_cuda_device(no_cuda, capsys):
    assert run.main(["--workload", "tinynerf.render", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(cell.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cell.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "tinynerf.render",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_result_line(cpu_program, workload):
    out = cell.run(cell.Options(workload, 2**31 + 11, 0.3, device="cpu",
                                overrides=SMALL[workload]), time.time())
    assert {"correct", "attempted", "failed", "metrics", "device", "checks"} <= set(out)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == set(cell.metric_names(workload, "end_to_end"))
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_a_trace_without_device_events_reports_no_per_layer_metric(cpu_program):
    """A reader that finds nothing returns nothing: never a 0 roofline."""
    out = cell.run(cell.Options("tinynerf.render", 5, 0.3, trace=True, device="cpu",
                                overrides=SMALL["tinynerf.render"]), time.time())
    assert out["metrics"] == {}


def test_sub_seeds_take_seeds_past_32_bits():
    seeds = {cell.sub_seed(s, 1) for s in (0, 1, 2**31 + 1, 2**33 + 7)}
    assert len(seeds) == 4 and all(0 <= s < 2**31 for s in seeds)
