"""The device DI plug-in whole (the port's span mtr.di.device: staging,
the card's upload, launch and copy back, the widening, the host finish),
seconds a read."""
from portbench import port_spans

LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.di.device" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.di.device"])
