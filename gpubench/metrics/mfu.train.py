"""mfu.train: the whole step's share of the chip's peak: the required MLP
FLOPs of the measured window's steps over the window's time (host clock,
profiler off), as a share of the H100's 989 TFLOP/s (bf16, dense)."""

from gpubench.core.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
