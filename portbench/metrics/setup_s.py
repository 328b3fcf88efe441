"""Process start to the window's start: imports, the card, loading or
building the port's libraries, generating the reads, the warm-up batch."""
LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(ctx):
    return ctx.setup_s
