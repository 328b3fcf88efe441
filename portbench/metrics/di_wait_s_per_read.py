"""The host's wait for the device DI group (the port's span mtr.di.wait:
the stream synchronize after the codes' upload, the group launch and the
copy back into pinned memory), seconds a read."""
from portbench import port_spans

LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.di.wait" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.di.wait"])
