"""Walk queries the device walks send to the host engine, of all walk
queries (the port's counters walk_fallback_queries / speculative_queries)."""
LAYER = "walk stage (pipeline.walk_batch, ops/dbg_device.py, csrc/dbg_walk.cu)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    q = ctx.counters.get("speculative_queries", 0)
    if not q:
        return None
    return 100.0 * ctx.counters.get("walk_fallback_queries", 0) / q
