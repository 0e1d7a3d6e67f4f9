"""weight_repacks.render: packs of weights that had not changed since the
same buffer's previous pack (the program's counter weight_repacks), per
view of the traced window: the packing a cache keyed by the parameters'
versions would not redo."""

from gpubench.core.program_spans import repacks


def read(ctx):
    return repacks(ctx, "render")
