"""90th percentile of due-to-completion seconds of the requests due in the window."""
from dndmbench import readers

LAYER = "run"
UNIT = "s"
MOVES = "latency_p90_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.latency(ctx, 90)
