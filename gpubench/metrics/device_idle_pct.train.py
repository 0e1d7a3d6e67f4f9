"""device_idle_pct.train: the share of the measured window in which the
device ran nothing, in percent: 100 times (1 - the traced window's device
busy time a step (the union of kernel, copy and set intervals) over the
measured window's time a step, the profiler off)."""

from gpubench.core.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "train")
