"""host_draw_ms.train: host time of the step's draw (the span step.draw:
the step generators, draw_ray_batch, the stack of the scenes' batches)
per step of the traced window, from the program's own spans."""

from gpubench.core.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "step.draw")
