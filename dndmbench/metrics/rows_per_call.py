"""Request NFE completed in the window over ContinuousScheduler.total_calls made in it."""
from dndmbench import readers

LAYER = "scheduler (serving/scheduler.py)"
UNIT = "rows"
MOVES = "latency_p50_s"
SOURCE = "program_counter"


def read(ctx):
    return readers.live_rows_per_call(ctx)
