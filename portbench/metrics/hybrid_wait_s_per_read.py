"""Seconds stage B waits for the hybrid's device leg once its host leg is
done (the port's span mtr.dp.hybrid_wait) a read."""
from portbench import port_spans

LAYER = "DP batcher and kernels (TorchDPBatcher, ops/wrap_dp_*.py, csrc/wrap_dp_*.cu)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.dp.hybrid_wait" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.dp.hybrid_wait"])
