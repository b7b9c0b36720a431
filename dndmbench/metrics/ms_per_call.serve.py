"""Window seconds over the network calls made in it."""
from dndmbench import readers

LAYER = "denoiser (models/)"
UNIT = "ms"
MOVES = "latency_p50_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.ms_per_call(ctx)
