"""The traced window: spans around the calls into the kernels, and the
reduction of torch.profiler's device events to the numbers the per-layer
readers take.

In a traced run, after the measured window, the harness traces a few
more units (blocks of steps, views) with torch.profiler, each in a span
`gpubench.unit`, and wraps each kernel's C entry point (named in
gpubench/kernel_names.json) in a span `gpubench.<K>`. A device event
belongs to a kernel when the host made its launch inside that kernel's
span: the launch's runtime event and the device event share their
correlation id. The device's busy time is the
union of its kernel, copy and set intervals inside the window, so events
that overlap count once.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np
import torch

SPAN = "gpubench."
UNIT = "gpubench.unit"
KERNEL_NAMES = Path(__file__).resolve().parents[1] / "kernel_names.json"


def kernel_names() -> dict:
    return json.loads(KERNEL_NAMES.read_text())


def wrap_entries(kernels) -> None:
    """Put a span `gpubench.<K>` around each named kernel's C entry point,
    for the rest of the process (a traced run only)."""
    names = kernel_names()
    for k in kernels:
        entry = names[k]
        lib = importlib.import_module(entry["module"])._lib()
        orig = getattr(lib, entry["entry"])

        def wrapped(*args, _orig=orig, _span=SPAN + k):
            with torch.profiler.record_function(_span):
                return _orig(*args)

        setattr(lib, entry["entry"], wrapped)


def profiler(n_active: int):
    """A profiler that discards one unit and records the next n_active."""
    from torch.profiler import ProfilerActivity, profile, schedule

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=n_active, repeat=1))


def unit_span():
    return torch.profiler.record_function(UNIT)


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals -> disjoint sorted intervals."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def summarise(events) -> dict:
    """The traced window's numbers from profiler events (times in s):
    window, busy (the union of device intervals), units traced; per kernel
    K its device time (the device events whose launch the
    host made inside a `gpubench.<K>` span: the launch's runtime event and
    the device event share their correlation id); the device time of the
    operations that no symbol of K1-K7 names (kernel_names.json); the ten
    device operations of most time and the ten longest idle gaps by the
    host operation running when each began."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu_ev = [e for e in events if e.device_type != cuda]
    dev_ev = [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation",
                                                                           False)]
    units = [e for e in cpu_ev if e.name == UNIT]
    if not units:
        return {}
    w0 = min(e.time_range.start for e in units)
    w1 = max(e.time_range.end for e in units)
    span_iv = sorted((e.time_range.start, e.time_range.end, e.name[len(SPAN):]) for e in cpu_ev
                     if e.name.startswith(SPAN) and e.name != UNIT)
    spans = {}
    for *_, k in span_iv:
        spans[k] = spans.get(k, 0) + 1
    starts = np.array([s for s, _, _ in span_iv], dtype=np.float64)
    launched_in = {}
    for e in cpu_ev:
        if e.name in LAUNCHES and len(starts):
            i = int(np.searchsorted(starts, e.time_range.start, side="right")) - 1
            if i >= 0 and e.time_range.start <= span_iv[i][1]:
                launched_in[e.id] = span_iv[i][2]
    names = kernel_names()
    symbols = {sym for k in names.values() for sym in k["symbols"]}

    iv = np.array([[e.time_range.start, e.time_range.end] for e in dev_ev],
                  dtype=np.float64).reshape(-1, 2)
    inside = (iv[:, 1] > w0) & (iv[:, 0] < w1)
    busy_iv = _union(np.clip(iv[inside], w0, w1))
    busy = float((busy_iv[:, 1] - busy_iv[:, 0]).sum()) if len(busy_iv) else 0.0

    per_kernel, outside, by_name = {}, 0.0, {}
    for e, keep in zip(dev_ev, inside):
        if not keep:
            continue
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        k = launched_in.get(e.id)
        if k is not None:
            per_kernel[k] = per_kernel.get(k, 0.0) + dur
        ours = any(sym in e.name for sym in symbols)
        if not ours:
            outside += dur
        name = k or (e.name[:80] if not ours else "K1-K7 (unattributed)")
        by_name[name] = by_name.get(name, 0.0) + dur

    gaps = []
    if len(busy_iv):
        edges = np.concatenate([[w0], busy_iv.ravel(), [w1]]).reshape(-1, 2)
        gaps = [(s, e) for s, e in edges if e > s]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    host = [e for e in cpu_ev if e.name != UNIT and not e.name.startswith("ProfilerStep")]
    hs = np.array([e.time_range.start for e in host], dtype=np.float64)
    he = np.array([e.time_range.end for e in host], dtype=np.float64)
    idle = {}
    for s, e in gaps:
        at = np.nonzero((hs <= s) & (he >= s))[0] if len(hs) else []
        name = host[at[np.argmax(hs[at])]].name[:80] if len(at) else "host, outside any operation"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6, "units": len(units),
            "kernel_s": per_kernel, "kernel_spans": spans, "outside_s": outside,
            "device_ops": top(by_name), "idle_gaps": top(idle)}
