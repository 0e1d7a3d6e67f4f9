"""host_encode_ms.train: host time of the grid encoding (the program's
spans grid.encode, the gather and blend inside the model's forward, and
grid.encode.bwd, the scatter-add of the backward) per step of the traced
window, from the program's own spans."""

from gpubench.core.program_spans import span_ms


def read(ctx):
    parts = [span_ms(ctx, "train", name) for name in ("grid.encode", "grid.encode.bwd")]
    return None if None in parts else sum(parts)
