"""The counts-mode DP's least time on the card (portbench.roofline,
counted from the scal handed to wrap_dp_counts) over all device time
launched inside the benchmark's ranges around wrap_dp_counts, in the
profiled span."""
LAYER = "DP batcher and kernels (TorchDPBatcher, ops/wrap_dp_*.py, csrc/wrap_dp_*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(ctx):
    r = ctx.trace.roofline("bench.counts") if ctx.trace else None
    return None if r is None else 100.0 * r[0] / r[1]
