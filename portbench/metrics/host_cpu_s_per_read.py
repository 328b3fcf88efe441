"""CPU seconds (user + system, every thread of the process, the native
engine's pool with them) over the window, a read."""
LAYER = "entry loop (cli.py, pipeline.run_file)"
UNIT = "s/read"
SOURCE = "host_clock"
MOVES = "reads_per_s"


def read(ctx):
    return ctx.per_read(ctx.cpu_s)
