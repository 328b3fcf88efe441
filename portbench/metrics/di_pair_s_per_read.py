"""The pairing of a k's device DI passes into candidate ranges (the
port's span mtr.di.pair: put_local_maximum over the plug-in's outputs,
on the reader thread), seconds a read."""
from portbench import port_spans

LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.di.pair" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.di.pair"])
