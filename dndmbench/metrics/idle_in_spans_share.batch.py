"""The share (%) of the device's idle time in the traced stretch during which
some program span was open on the host."""
from dndmbench import spans

LAYER = "device (H100)"
UNIT = "%"
MOVES = "tokens_per_s"
SOURCE = "program_span"


def read(ctx):
    return spans.idle_in_spans_share(ctx)
