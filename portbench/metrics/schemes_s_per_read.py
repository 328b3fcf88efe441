"""Stage B's scheme selection, the DP jobs of both schemes for every walk
candidate (the port's span mtr.stage_b.schemes), seconds a read."""
from portbench import port_spans

LAYER = "wave loop (pipeline.process_batch, _polish_phase)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.stage_b.schemes" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.stage_b.schemes"])
