"""The device DI group's host finish (the port's spans mtr.di.widen, the
int32 outputs widened, and mtr.di.finish, the float64 DI of every pass
of the group), seconds a read."""
from portbench import port_spans

LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = ("mtr.di.widen", "mtr.di.finish")


def read(ctx):
    port_spans.report(ctx)
    if not any(k in ctx.timers for k in SPANS):
        return None
    return ctx.per_read(sum(ctx.timers.get(k, 0.0) for k in SPANS))
