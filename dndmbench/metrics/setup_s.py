"""Process start to window open: imports, the kernels' build or load, weights, warm-up and the ramp."""
LAYER = "run"
UNIT = "s"
MOVES = "setup_s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
