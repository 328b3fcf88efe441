"""Stage B's seconds a read: the benchmark's span around
pipeline.process_batch (the wave loop, DP jobs, polish, chaining), less
the extra waves' walks inside it (their own walk_batch spans)."""
LAYER = "wave loop (pipeline.process_batch, _polish_phase)"
UNIT = "s/read"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    b = ctx.span_s("bench.stage_b")
    if not b:
        return None
    return ctx.per_read(b - ctx.span_s("bench.walks", nested=True))
