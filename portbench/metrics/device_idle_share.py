"""The share of the profiled span in which no kernel, copy or set ran on
the card."""
LAYER = "device (NVIDIA H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_ns <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns / ctx.trace.window_ns)
