"""host_wrappers_ms.train: host time inside the K1-K7 wrappers (each a span
with a .pack and a .launch) per step of the traced window, from the
program's own spans."""

from gpubench.core.program_spans import wrappers_ms


def read(ctx):
    return wrappers_ms(ctx, "train")
