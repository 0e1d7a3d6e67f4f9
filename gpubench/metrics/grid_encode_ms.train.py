"""grid_encode_ms.train: device time of the grid encoding per step of the
traced window: the device events launched inside the spans
gpubench.grid_encode (the port's encode_levels: the gather and blend) and
gpubench.grid_encode_bwd (encode_levels_bwd: the scatter-add into the
tables), whatever implements them."""

from gpubench.core.readers import _units

PASSES = ("grid_encode", "grid_encode_bwd")


def read(ctx):
    n = _units(ctx, "train")
    seconds = [ctx["trace"].get("kernel_s", {}).get(p) for p in PASSES]
    if n is None or not all(seconds):
        return None
    return 1e3 * sum(seconds) / n
