"""One run of one cell: what every loop shares.

A cell names a configuration (gpubench/configs/<config>.json) and a
traffic mix (gpubench/traffic/<traffic>.json). The configuration's
"family" names the system under test (gpubench/systems/<family>.py) and
its reference (gpubench/reference/<family>.py); the mix's "kind" names
the loop that drives it (gpubench/loops/<kind>.py: set-up, the measured
window, the traced one, the check). Every input (scenes, poses, weights)
is made from the seed, on the device. The route each kernel launch has to
take is data too: the configuration's "route", with the mix's merged in.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import threading
import time
from pathlib import Path

import torch

from gpubench.core import check, trace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
_MASK64 = (1 << 64) - 1
COUNTERS = ("launches", "mma_launches", "general_launches", "spill_launches", "scene_launches")


@dataclasses.dataclass
class Options:
    workload: str
    seed: int
    seconds: float
    trace: bool = False
    device: str = "cuda"
    fault: str = ""  # the harness's own tests: a planted fault
    overrides: dict = dataclasses.field(default_factory=dict)  # the tests' small sizes


class Clock:
    """Set-up's phases: the seconds from the previous mark to each."""

    def __init__(self, t0: float):
        self.t0 = self.t = t0
        self.phases = {}

    def mark(self, name: str) -> None:
        now = time.time()
        self.phases[name] = now - self.t
        self.t = now

    def total(self) -> float:
        return self.t - self.t0


def sub_seed(seed: int, salt: int) -> int:
    """A 31-bit seed for one use of the run's seed (splitmix64)."""
    h = (int(seed) ^ (salt * 0x9E3779B97F4A7C15)) & _MASK64
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
    return (h ^ (h >> 31)) & 0x7FFFFFFF


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, overrides: dict | None = None):
    """(cell, configuration, traffic) by name, with the tests' overrides
    ({"config": {...}, "traffic": {...}}) applied."""
    cells = {c["name"]: c for c in spec()["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec()["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return cell, cfg, traffic


def system_of(cfg: dict):
    return importlib.import_module(f"gpubench.systems.{cfg['family']}")


def loop_of(traffic: dict):
    return importlib.import_module(f"gpubench.loops.{traffic['kind']}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prebuild(kernels, dev) -> threading.Thread | None:
    """Build the kernels' libraries (nvcc, in parallel) while the inputs
    are made; a warm checkout finds them built. None off the card."""
    if dev.type != "cuda":
        return None
    names = trace.kernel_names()
    libs = sorted({names[k]["library"] for k in kernels})
    from tinynerf_tpu_torch.kernels import _build

    def one(lib):
        try:
            _build.build(lib)
        except Exception:  # raised again when the kernel is first launched
            pass

    threads = [threading.Thread(target=one, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    joiner = threading.Thread(target=lambda: [t.join() for t in threads])
    joiner.start()
    return joiner


def reset_counters(counters: dict) -> None:
    for fn in counters.values():
        for attr in COUNTERS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def route_of(cfg: dict, traffic: dict) -> dict:
    """The route every launch has to take: {"all": counters that count
    every launch, "none": counters that count none}, the configuration's
    with the mix's added."""
    route = {"all": [], "none": []}
    for src in (cfg.get("route", {}), traffic.get("route", {})):
        for key in route:
            route[key] += [c for c in src.get(key, []) if c not in route[key]]
    return route


def off_route(counters: dict, expected: dict, route: dict) -> int:
    """Launches off the route: the gap of each kernel's count to the
    expected one, each launch that a counter of route["all"] missed, and
    each one that a counter of route["none"] took."""
    bad = 0
    for k, fn in counters.items():
        n = fn.launches
        bad += abs(n - expected[k])
        bad += sum(n - getattr(fn, c, 0) for c in route["all"])
        bad += sum(getattr(fn, c, 0) for c in route["none"])
    return int(bad)


def metric_names(cell: str, section: str) -> list:
    return [m["name"] for m in spec()[section]
            if "workloads" not in m or cell in m["workloads"]]


def read_per_layer(cell: str, ctx: dict) -> dict:
    """Each per-layer metric of the cell from its reader,
    gpubench/metrics/<name>.py; a reader that finds nothing returns None
    and the metric is left out."""
    units = {m["name"]: m["unit"] for m in spec()["per_layer"]}
    out = {}
    for name in metric_names(cell, "per_layer"):
        path = BENCH / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": units[name]}
    return out


def run(opts: Options, t0: float) -> dict:
    """One run -> the result line's dict (without the import check). The
    loop returns "kind" (the kind its readers take it for), "attempted",
    "failed", "readings", "peak", "trace", "work", "steps_per_unit",
    "window" and "measured" (the end-to-end metrics)."""
    clock = Clock(t0)
    clock.mark("imports")
    cell, cfg, traffic = load_cell(opts.workload, opts.overrides)
    system, loop = system_of(cfg), loop_of(traffic)
    clock.mark("program_imports")
    dev = torch.device(opts.device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    clock.mark("device")
    out = loop.run(opts, cfg, traffic, system, dev, clock)
    out["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": int(cell["chips"]), "memory_peak_bytes": out.pop("peak")}
    summary = out.pop("trace", None)
    ctx = {"kind": out.pop("kind"), "trace": summary or {}, "work": out.pop("work"),
           "steps_per_unit": out.pop("steps_per_unit"), "window": out["window"]}
    if opts.trace:
        out["metrics"] = read_per_layer(opts.workload, ctx)
        if summary:
            out["device"]["busy_s"] = summary["busy_s"]
            out["device"]["window_s"] = summary["window_s"]
            out["breakdown"] = {"device_ops": summary["device_ops"],
                                "idle_gaps": summary["idle_gaps"]}
    else:
        names = metric_names(opts.workload, "end_to_end")
        units = {m["name"]: m["unit"] for m in spec()["end_to_end"]}
        out["metrics"] = {n: {"value": out["measured"][n], "unit": units[n]} for n in names}
    out["window"]["setup_s"] = out.pop("measured")["setup_s"]
    out["window"]["setup_phases"] = clock.phases
    correct, checks = check.verdict(out.pop("readings"), check.limits(opts.workload))
    out["correct"] = correct
    out["checks"] = checks
    return out


def window(seconds: float, unit_fn, first: int = 0) -> tuple:
    """Run unit_fn(i) until the window has lasted `seconds`; -> (seconds,
    units). Each unit ends on the host (a sync or a copy)."""
    t_start = time.perf_counter()
    i = first
    while True:
        unit_fn(i)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            return time.perf_counter() - t_start, i - first


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def traced(dev, kernels, unit_s: float, unit_fn, first: int) -> dict:
    """After the measured window, a traced one: one unit the profiler
    discards, then units for about two seconds, each in a span, with a
    span around every kernel entry -> trace.summarise's numbers."""
    if dev.type == "cuda":
        trace.wrap_entries(kernels)
    n = max(1, math.ceil(2.0 / max(unit_s, 1e-3)))
    prof = trace.profiler(n)
    prof.start()
    for i in range(first, first + 1 + n):
        with trace.unit_span():
            unit_fn(i)
        prof.step()
    prof.stop()
    return trace.summarise(prof.events())


def finish(dev, counters, expected, route) -> tuple:
    """After the window: (the device's peak, the route's reading)."""
    if dev.type != "cuda":
        return 0, {}
    return (int(torch.cuda.max_memory_allocated(dev)),
            {"launches_off_route": off_route(counters, expected, route)})
