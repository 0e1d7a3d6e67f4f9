"""Lightweight tracing/profiling utilities.

Port of tinynerf_tpu/utils/profiling.py:1-96, with the same API and
statistics:

- `Timer`: host-side named-section timer; a section given a tensor waits
  for the device (`sync`) before it stops the clock, so it times the
  work and not its enqueue;
- `StepTimer`: rolling per-step latency statistics (p50/p95/max);
- `trace`: a context manager around torch.profiler (CPU and, with a card,
  CUDA activities) that writes a Chrome trace (viewable in Perfetto or
  chrome://tracing) into `profile_dir`; a no-op when it is falsy.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


def sync(x) -> None:
    """Wait for the device work behind x: torch.cuda.synchronize on x's
    card for a CUDA tensor (or a sequence or dict holding one), nothing
    on the CPU."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for t in x:
            sync(t)
        return
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class Timer:
    """Accumulating named-section timer.

    with timer.section("render", result):  # result forces sync if given
        ...
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            sync(sync_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }


class StepTimer:
    """Rolling step-latency statistics."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples: list = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples) * 1e3
        return {
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "max_ms": float(a.max()),
        }


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """torch.profiler trace scope writing profile_dir/trace_<pid>.json
    (a Chrome trace); no-op when profile_dir is falsy. Traces the CPU,
    and the CUDA device when one is present. Yields the profiler (None
    when off)."""
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{os.getpid()}.json"))
