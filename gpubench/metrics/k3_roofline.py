"""k3_roofline: K3's bound (its launches' work, counted from the shapes)
over its measured device time in the traced window, in percent."""

from gpubench.core.readers import roofline


def read(ctx):
    return roofline(ctx, "K3")
