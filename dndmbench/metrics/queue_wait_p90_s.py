"""90th percentile of due-to-admission seconds, on the harness's clock."""
from dndmbench import readers

LAYER = "scheduler (serving/scheduler.py)"
UNIT = "s"
MOVES = "latency_p90_s"
SOURCE = "host_clock"


def read(ctx):
    return readers.queue_wait(ctx, 90)
