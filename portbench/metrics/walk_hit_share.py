"""Walk queries whose walk found a unit, of all walk queries (the port's
counters walk_hit_queries / speculative_queries)."""
from portbench import port_spans

LAYER = "walk stage (pipeline.walk_batch, ops/dbg_device.py, csrc/dbg_walk.cu)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    port_spans.report(ctx)
    q = ctx.counters.get("speculative_queries", 0)
    if "walk_hit_queries" not in ctx.counters or not q:
        return None
    return 100.0 * ctx.counters["walk_hit_queries"] / q
