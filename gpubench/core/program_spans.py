"""What the readers of the program's own spans share (gpubench/metrics/
host_*.py and weight_repacks.render.py): the totals that the port's
recorder (tinynerf_tpu_torch/utils/profiling.py: spans()) kept while the
traced window's profiler recorded, per step or per view of that window.

The recorder keeps (name, parent) -> count, total and self seconds; here
they are summed over parents. A step or a view is the recorder's own
count of `step` or `view` spans. A kernel wrapper is a span with a
`<wrapper>.launch` child; its packing is `<wrapper>.pack`, and the
counter `weight_repacks` counts the packs of weights unchanged since the
buffer's previous pack. Each function gives None where
readers._units does (no device time, or another kind of cell), where the
program keeps no such totals (a program without the recorder), or where
the recorder saw no step or view; never a 0 it did not read.
"""

from __future__ import annotations

from gpubench.core.readers import _units

UNIT_SPAN = {"train": "step", "render": "view"}


def totals():
    """{name: [count, total seconds]} summed over parents, or None where
    the program keeps no such totals."""
    try:
        from tinynerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    out = {}
    for (name, _), v in read().items():
        t = out.setdefault(name, [0, 0.0])
        t[0] += v["count"]
        t[1] += v["total_s"]
    return out


def _read(ctx: dict, kind: str):
    """(totals, units) of the traced window, or None."""
    if _units(ctx, kind) is None:
        return None
    t = totals()
    n = t.get(UNIT_SPAN[kind], [0])[0] if t else 0
    return (t, n) if n else None


def wrappers(t: dict) -> list:
    return [name[:-len(".launch")] for name in t if name.endswith(".launch")]


def span_ms(ctx: dict, kind: str, name: str):
    """Host milliseconds of the spans `name` a unit; None where none ran."""
    got = _read(ctx, kind)
    if got is None or name not in got[0]:
        return None
    t, n = got
    return 1e3 * t[name][1] / n


def wrappers_ms(ctx: dict, kind: str):
    """Host milliseconds of the kernel wrappers' spans a unit."""
    got = _read(ctx, kind)
    if got is None or not wrappers(got[0]):
        return None
    t, n = got
    return 1e3 * sum(t[w][1] for w in wrappers(t) if w in t) / n


def packs_ms(ctx: dict, kind: str):
    """Host milliseconds of every wrapper's `.pack` a unit (where wrappers
    ran)."""
    got = _read(ctx, kind)
    if got is None or not wrappers(got[0]):
        return None
    t, n = got
    return 1e3 * sum(v[1] for name, v in t.items() if name.endswith(".pack")) / n


def repacks(ctx: dict, kind: str):
    """Packs of unchanged weights a unit (where wrappers ran)."""
    got = _read(ctx, kind)
    if got is None or not wrappers(got[0]):
        return None
    t, n = got
    return t.get("weight_repacks", [0])[0] / n
