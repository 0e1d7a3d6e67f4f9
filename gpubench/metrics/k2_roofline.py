"""k2_roofline: K2's bound (its launches' work, counted from the shapes)
over its measured device time in the traced window, in percent."""

from gpubench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "K2")
