"""1 - the union of the device's operations over the traced window, in %."""
from dndmbench import readers

LAYER = "device (H100)"
UNIT = "%"
MOVES = "latency_p50_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.idle_share(ctx)
