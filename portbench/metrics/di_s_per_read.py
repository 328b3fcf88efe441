"""The reader thread's DI seconds (the port's TIMERS "range") a read."""
LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    return ctx.per_read(ctx.timers.get("range", 0.0))
