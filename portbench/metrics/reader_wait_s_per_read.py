"""Seconds the reader thread waits for the walk thread and for stage B
(the port's spans mtr.read.wait_walks and mtr.read.wait_stage_b) a read."""
from portbench import port_spans

LAYER = "entry loop (cli.py, pipeline.run_file)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"
SPANS = ("mtr.read.wait_walks", "mtr.read.wait_stage_b")


def read(ctx):
    port_spans.report(ctx)
    if not any(k in ctx.timers for k in SPANS):
        return None
    return ctx.per_read(sum(ctx.timers.get(k, 0.0) for k in SPANS))
