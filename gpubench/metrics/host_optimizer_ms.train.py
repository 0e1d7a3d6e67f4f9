"""host_optimizer_ms.train: host time of the optimizer (the span
step.optimizer: Adam's step and the gradient cleared) per step of the
traced window, from the program's own spans."""

from gpubench.core.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "step.optimizer")
