"""torch_ops_ms.train: device time of every operation launched outside the
K1-K7 spans (eager torch: draws, sampling, packing, the optimizer), per
step."""

from gpubench.core.readers import torch_ops_ms


def read(ctx):
    return torch_ops_ms(ctx, "train")
