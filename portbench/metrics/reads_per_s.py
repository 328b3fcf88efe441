"""Reads whose records the port wrote inside the window, over the window."""
LAYER = "end to end"
UNIT = "reads/s"
SOURCE = "host_clock"
MOVES = None


def read(ctx):
    return ctx.reads / ctx.seconds if ctx.reads else None
