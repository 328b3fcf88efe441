"""The walk thread's walk seconds (the port's TIMERS "walks") a read."""
LAYER = "walk stage (pipeline.walk_batch, ops/dbg_device.py, csrc/dbg_walk.cu)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    return ctx.per_read(ctx.timers.get("walks", 0.0))
