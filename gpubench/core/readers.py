"""What the per-layer readers (gpubench/metrics/<name>.py) share: each
takes the traced window's summary (core/trace.py), the measured window's
seconds and units, the work of one step or view (the system's unit_work)
and the kind the loop reads as, and returns a number or None where it
finds nothing to read.
"""

from __future__ import annotations

from gpubench.core.work import PEAK_FLOPS, bound_s


def _units(ctx: dict, kind: str):
    """Steps or views in the traced window, or None off this kind of cell
    or in a trace that holds no device time."""
    t = ctx["trace"]
    if (ctx["kind"] != kind or not t or not t.get("units") or t.get("window_s", 0) <= 0
            or t.get("busy_s", 0) <= 0):
        return None
    return t["units"] * ctx["steps_per_unit"]


def mfu(ctx: dict, kind: str):
    """The whole step's (or view's) share of the chip's peak: the measured
    window's required FLOPs over its time (the host's clock, with the
    profiler off) and the bf16 peak. It bounds every kernel's roofline
    from above only while idle time and the other layers count in it, so
    it is taken over the window and not over the device's busy time;
    reported in a run whose trace shows the device at work."""
    if _units(ctx, kind) is None:
        return None
    w = ctx["window"]
    return 100.0 * w["units"] * ctx["steps_per_unit"] * ctx["work"]["flops"] / (
        w["seconds"] * PEAK_FLOPS)


def idle_pct(ctx: dict, kind: str):
    """The share of the measured window in which no operation ran on the
    device: the traced window's device time a unit (the union of its
    kernel, copy and set intervals, which the profiler barely moves) over
    the measured window's time a unit (the profiler off, since it slows
    the host). Below 0 where tracing lengthens the device's work by more
    than the device idles."""
    if _units(ctx, kind) is None:
        return None
    t, w = ctx["trace"], ctx["window"]
    return 100.0 * (1.0 - (t["busy_s"] / t["units"]) / (w["seconds"] / w["units"]))


def torch_ops_ms(ctx: dict, kind: str):
    """Device time of every operation outside the kernels' spans, per unit."""
    n = _units(ctx, kind)
    if n is None:
        return None
    return 1e3 * ctx["trace"]["outside_s"] / n


def roofline(ctx: dict, kernel: str):
    """The kernel's bound over its measured device time in the window: the
    bound of each launch's work (operations over the bf16 peak or bytes
    over the memory rate), summed over the units traced."""
    t = ctx["trace"]
    work = ctx["work"]["kernels"].get(kernel)
    if not work or _units(ctx, ctx["kind"]) is None:
        return None
    seconds = t["kernel_s"].get(kernel)
    if not seconds:
        return None
    n = t["units"] * ctx["steps_per_unit"]
    return 100.0 * n * sum(bound_s(f, b) for f, b in work) / seconds
