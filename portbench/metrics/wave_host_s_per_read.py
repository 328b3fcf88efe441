"""Stage B's host work between its DP phases (the port's spans
mtr.stage_b.select, .ksweep, .replay, .next_wave and .chaining), seconds
a read."""
from portbench import port_spans

LAYER = "wave loop (pipeline.process_batch, _polish_phase)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = ("mtr.stage_b.select", "mtr.stage_b.ksweep", "mtr.stage_b.replay",
         "mtr.stage_b.next_wave", "mtr.stage_b.chaining")


def read(ctx):
    port_spans.report(ctx)
    if not any(k in ctx.timers for k in SPANS):
        return None
    return ctx.per_read(sum(ctx.timers.get(k, 0.0) for k in SPANS))
