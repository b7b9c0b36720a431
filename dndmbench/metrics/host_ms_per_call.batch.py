"""The host's own ms per traced network call, outside CUDA runtime calls."""
from dndmbench import readers

LAYER = "engine (serving/engine.py)"
UNIT = "ms"
MOVES = "tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    return readers.host_ms_per_call(ctx)
