"""BENCHMARK.json against the benchmark's contract, and the layout that
lets a later change add a cell as data alone."""

from __future__ import annotations

import json
import re
import shutil
from types import SimpleNamespace

import pytest

from gpubench.core import cell, check

SPEC = json.loads((cell.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def line_text(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "gpubench/run.py"]
    assert SPEC["paths"] == ["gpubench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((cell.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in SPEC[sec]}) == len(SPEC[sec])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line_text(w["why"])
    for c in SPEC["configs"]:
        assert line_text(c["source"]) and line_text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["per_layer"]:
        assert line_text(m["layer"])


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in SPEC["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_cells_metrics_and_configs_fit_together():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("gpubench/") for f in files)
    for w in CELLS:
        reported = cell.metric_names(w, "end_to_end")
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metric_names(w, "per_layer")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in CELLS and w in e2e[m["moves"]].get("workloads", CELLS)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files_by_name(workload):
    c, cfg, traffic = cell.load_cell(workload)
    assert cfg["name"] == c["config"]
    loop = cell.loop_of(traffic)
    assert callable(loop.run) and callable(loop.control)
    system = cell.system_of(cfg)
    assert system.KERNELS[traffic["kind"]]
    assert cell.route_of(cfg, traffic)["all"]
    assert set(check.limits(workload)) >= {"launches_off_route"}
    for name in cell.metric_names(workload, "per_layer"):
        assert (cell.BENCH / "metrics" / f"{name}.py").exists()


def test_files_are_named_from_name_characters():
    for p in cell.BENCH.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(cell.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_cell_added_as_data_alone(tmp_path, monkeypatch):
    """A new configuration, traffic mix, limits and cell are new files and
    new entries: nothing that is there is edited."""
    shutil.copytree(cell.BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((cell.BENCH / "configs" / "nerf-paper.json").read_text())
    cfg.update(name="nerf-wide", rgb_hidden=256)
    (tmp_path / "gpubench" / "configs" / "nerf-wide.json").write_text(json.dumps(cfg))
    (tmp_path / "gpubench" / "traffic" / "train_2k.json").write_text(json.dumps(
        {"kind": "train", "scenes": 1, "views_per_scene": 8, "size": 100,
         "rays_per_scene": 2048, "block_steps": 50}))
    (tmp_path / "gpubench" / "limits" / "nerf-wide.train-2k.json").write_text(
        json.dumps({"loss_rel": 0.01, "launches_off_route": 0}))
    spec["configs"].append({"name": "nerf-wide", "source": "https://arxiv.org/abs/2003.08934",
                            "file": "gpubench/configs/nerf-wide.json", "reduced": [],
                            "why": "a wider view branch"})
    spec["workloads"].append({"name": "nerf-wide.train-2k", "config": "nerf-wide",
                              "traffic": "train_2k", "chips": 1, "why": "2048 rays a step"})
    spec["end_to_end"][0]["workloads"].append("nerf-wide.train-2k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(cell, "ROOT", tmp_path)
    monkeypatch.setattr(cell, "BENCH", tmp_path / "gpubench")
    monkeypatch.setattr(check, "LIMITS", tmp_path / "gpubench" / "limits")
    c, cfg2, traffic = cell.load_cell("nerf-wide.train-2k")
    assert cfg2["rgb_hidden"] == 256 and traffic["rays_per_scene"] == 2048
    assert cell.metric_names("nerf-wide.train-2k", "end_to_end") == ["train_rays_per_s",
                                                                     "setup_s"]
    work = cell.system_of(cfg2).unit_work(cfg2, traffic, "train")
    assert work["flops"] > 0 and check.limits("nerf-wide.train-2k")["loss_rel"] == 0.01


def counter(**counts):
    return SimpleNamespace(**counts)


@pytest.mark.parametrize("route, counts, off", [
    ({"all": ["mma_launches"], "none": ["general_launches", "spill_launches"]},
     dict(launches=4, mma_launches=4, general_launches=0, spill_launches=0), 0),
    ({"all": ["mma_launches"], "none": ["general_launches", "spill_launches"]},
     dict(launches=4, mma_launches=3, general_launches=1, spill_launches=0), 2),
    ({"all": ["general_launches", "spill_launches"], "none": ["mma_launches"]},
     dict(launches=4, mma_launches=0, general_launches=4, spill_launches=4), 0),
    ({"all": ["scene_launches"], "none": []}, dict(launches=4), 4),
    ({"all": [], "none": []}, dict(launches=5), 1),
])
def test_the_route_is_the_data_of_the_configuration_and_the_mix(route, counts, off):
    """Each launch on the route that the files name: counted by every
    counter of "all", by none of "none", and as many as expected."""
    assert cell.off_route({"K": counter(**counts)}, {"K": 4}, route) == off


def test_the_mix_adds_to_the_configurations_route():
    cfg = {"route": {"all": ["mma_launches"], "none": ["spill_launches"]}}
    traffic = {"route": {"all": ["scene_launches", "mma_launches"]}}
    assert cell.route_of(cfg, traffic) == {"all": ["mma_launches", "scene_launches"],
                                           "none": ["spill_launches"]}
    assert cell.route_of({}, {}) == {"all": [], "none": []}
