"""device_idle_pct.render: the share of the measured window in which the
device ran nothing, in percent: 100 times (1 - the traced window's device
busy time a view (the union of kernel, copy and set intervals) over the
measured window's time a view, the profiler off)."""

from gpubench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "render")
