"""Tokens completed in the window over its length, closed loop."""
LAYER = "run"
UNIT = "tokens/s"
MOVES = "tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return (ctx.tokens / ctx.window_s if ctx.traffic['loop'] == 'closed' and ctx.window_s else None)
