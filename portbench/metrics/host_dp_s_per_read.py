"""The hybrid's host leg: native DP seconds (the port's TIMERS "dp_fill") a read."""
LAYER = "native host engine (native.py, native/mtr_host.cpp)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    return ctx.per_read(ctx.timers.get("dp_fill", 0.0))
