"""Seconds stage B waits for the device DP results (the port's TIMERS
"dp_wait") a read."""
LAYER = "DP batcher and kernels (TorchDPBatcher, ops/wrap_dp_*.py, csrc/wrap_dp_*.cu)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    return ctx.per_read(ctx.timers.get("dp_wait", 0.0))
