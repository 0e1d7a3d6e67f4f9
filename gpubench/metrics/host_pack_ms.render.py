"""host_pack_ms.render: host time of the wrappers' weight packing (every
<wrapper>.pack span) per view of the traced window, from the program's
own spans."""

from gpubench.core.program_spans import packs_ms


def read(ctx):
    return packs_ms(ctx, "render")
