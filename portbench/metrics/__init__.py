"""One reader a metric: `read(ctx)` returns the number, or None where
the run gave it nothing to read (the harness then leaves it out).  A
reader states its LAYER, UNIT, SOURCE and the end-to-end metric it
MOVES, as BENCHMARK.json does."""
