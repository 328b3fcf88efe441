"""The DI group launches' least time on the card (portbench.roofline,
counted from the passes handed to the port's DI plug-in) over all device
time launched inside the benchmark's ranges around that plug-in (the
group's copies with it), in the profiled span."""
LAYER = "directional index (ops/directional_index.py, csrc/directional_index.cu, native DI)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(ctx):
    r = ctx.trace.roofline("bench.di_device") if ctx.trace else None
    return None if r is None else 100.0 * r[0] / r[1]
