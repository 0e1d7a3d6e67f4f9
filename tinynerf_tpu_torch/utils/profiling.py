"""Tracing: the program's spans and counters, and the Chrome trace.

- `span(name)`: a named section of the program (the step and its draw,
  gradient and optimizer; the view, its rays and chunks; `sample_pdf`;
  each kernel wrapper with its `.pack` and `.launch`). Tracing is on
  exactly while a torch.profiler records: then the span is a
  `record_function` event in the profiler's own timeline, on the device
  events' clock, and its host time (perf_counter_ns) is added to totals
  kept by (name, parent span): count, total and self time (the total less
  its child spans'). Off, `span` returns one shared no-op context;
- `spanned`: a decorator, each call of the function in a span named
  after it;
- `pack_span(name, module)`: a wrapper's weight packing, a span that also
  counts `weight_repacks` when the module's parameters are at the versions
  of its previous pack (work that a cache keyed by versions would not
  redo);
- `count(name, n)`: a counter in the same totals, counted while on;
- `spans()` / `reset_spans()`: a copy of the totals / clear them. The
  totals are aggregates, so a long run does not grow them; the single
  spans are in the profiler's trace;
- `trace`: a context manager around torch.profiler (CPU and, with a card,
  CUDA activities) that writes a Chrome trace (viewable in Perfetto or
  chrome://tracing), the spans included, into `profile_dir`; a no-op when
  it is falsy.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
import weakref
from typing import Dict, Optional, Tuple

import torch

_on = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_totals: Dict[Tuple[str, Optional[str]], list] = {}  # (name, parent) -> [count, total, children] ns
_open: list = []  # the open spans, innermost last: [name, children's ns]
# module -> (its parameters, read at its first pack; {pack span: their versions at its last})
_packed = weakref.WeakKeyDictionary()


class _Span:
    __slots__ = ("name", "counter", "record", "t0")

    def __init__(self, name: str, counter: Optional[str] = None):
        self.name, self.counter = name, counter

    def __enter__(self):
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        _open.append([self.name, 0])
        if self.counter:
            _totals.setdefault((self.counter, self.name), [0, 0, 0])[0] += 1
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        name, children = _open.pop()
        parent = _open[-1][0] if _open else None
        if _open:
            _open[-1][1] += dt
        t = _totals.setdefault((name, parent), [0, 0, 0])
        t[0] += 1
        t[1] += dt
        t[2] += children
        self.record.__exit__(*exc)
        return False


def span(name: str):
    """A span named `name` while a profiler records, else a shared no-op."""
    return _Span(name) if _on() else _OFF


def spanned(fn):
    """fn, each call in a span named after it."""
    name = fn.__name__

    @functools.wraps(fn)
    def in_span(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return in_span


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (under the innermost open span) while a
    profiler records."""
    if _on():
        _totals.setdefault((name, _open[-1][0] if _open else None), [0, 0, 0])[0] += n


def pack_span(name: str, module: torch.nn.Module):
    """The span `name` around the packing of `module`'s weights; while on,
    it counts `weight_repacks` when every parameter is at the version it
    had at the module's previous pack by this span (the same buffers
    packed again from the same weights). The versions are kept at every
    pack, on or off, so that the first pack of a traced window compares
    with the one before it; the parameters are read at a module's first
    pack."""
    rec = _packed.get(module)
    if rec is None:
        rec = _packed[module] = (tuple(module.parameters()), {})
    ps, last = rec
    versions = tuple([p._version for p in ps])
    same = last.get(name) == versions
    last[name] = versions
    if not _on():
        return _OFF
    return _Span(name, "weight_repacks" if same else None)


def spans() -> Dict[Tuple[str, Optional[str]], Dict[str, float]]:
    """{(name, parent): {"count", "total_s", "self_s"}} of every span and
    counter recorded since the last reset (parent None at the top; a
    counter has no time)."""
    return {k: {"count": c, "total_s": tot * 1e-9, "self_s": (tot - ch) * 1e-9}
            for k, (c, tot, ch) in _totals.items()}


def reset_spans() -> None:
    _totals.clear()


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
