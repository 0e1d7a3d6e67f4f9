"""grid_encode_roofline: the grid encoding's bound over its device time in
the traced window, in percent: each pass's work (systems/grid.py:
encode_pass, bound by its bytes at 3.35 TB/s) summed over the steps
traced, over the device time of the events launched inside the spans
gpubench.grid_encode and gpubench.grid_encode_bwd. The same work whatever
implements the encoding, so a fused kernel is judged on it."""

from gpubench.core.readers import _units
from gpubench.core.work import bound_s

PASSES = ("grid_encode", "grid_encode_bwd")


def read(ctx):
    n = _units(ctx, "train")
    work = ctx["work"]["kernels"]
    seconds = [ctx["trace"].get("kernel_s", {}).get(p) for p in PASSES]
    if n is None or not all(seconds) or not all(work.get(p) for p in PASSES):
        return None
    bound = sum(bound_s(f, b) for p in PASSES for f, b in work[p])
    return 100.0 * n * bound / sum(seconds)
