"""A run with the timed path broken underneath comes out not correct:
the harness driven past its look for a chip, on the CPU (the kernels'
plain versions), at the small sizes of conftest.SMALL, against the same
run unbroken."""

from __future__ import annotations

import time

import pytest

from gpubench.core import cell

from .conftest import SMALL

CASES = [(w, f) for w in ("nerf-paper.train", "tinynerf.train-8scenes")
         for f in ("frozen", "half_batch", "altered")]
CASES += [(w, f) for w in ("nerf-paper.render", "tinynerf.render")
          for f in ("half_batch", "altered")]


def one(workload, fault=""):
    return cell.run(cell.Options(workload, 77, 0.2, device="cpu", fault=fault,
                                 overrides=SMALL[workload]), time.time())


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_planted_fault_is_not_correct(cpu_program, workload, fault):
    sound = one(workload)["checks"]
    broken = one(workload, fault)
    assert broken["correct"] is False
    worse = [k for k, c in broken["checks"].items() if c["limit"] is not None
             and c["value"] > c["limit"] and c["value"] > 3 * sound[k]["value"]]
    assert worse, broken["checks"]


@pytest.mark.parametrize("fault", ["", "half_batch"])
def test_a_nerf_cell_on_the_scene_axis_is_data_alone(cpu_program, fault):
    """The NeRF family takes its scene count from the mix: two scenes
    through the multi-scene trainer, checked against the reference."""
    traffic = dict(SMALL["nerf-paper.train"]["traffic"], scenes=2)
    out = cell.run(cell.Options("nerf-paper.train", 2**31 + 5, 0.2, device="cpu", fault=fault,
                                overrides={"traffic": traffic}), time.time())
    assert out["correct"] is (fault == "")
    assert out["attempted"] == traffic["block_steps"]
