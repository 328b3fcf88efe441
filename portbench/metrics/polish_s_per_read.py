"""Stage B's polish and revision rounds (the port's span
mtr.stage_b.polish: polish_repeat, the consensus DP and unit rebuild, the
re-scoring DP), seconds a read."""
from portbench import port_spans

LAYER = "wave loop (pipeline.process_batch, _polish_phase)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    if "mtr.stage_b.polish" not in ctx.timers:
        return None
    return ctx.per_read(ctx.timers["mtr.stage_b.polish"])
