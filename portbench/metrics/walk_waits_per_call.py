"""Blocking waits of the device walk route for the card a call (the
port's counters walk_waits / walk_device_calls): how often
dbg_walk_device_batch hands the interpreter lock back and waits to get
it again.  None where the route was not called or does not count its
waits."""
LAYER = "walk stage (pipeline.walk_batch, ops/dbg_device.py, csrc/dbg_walk.cu)"
UNIT = "waits/call"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    calls = ctx.counters.get("walk_device_calls", 0)
    if not calls or "walk_waits" not in ctx.counters:
        return None
    return ctx.counters["walk_waits"] / calls
