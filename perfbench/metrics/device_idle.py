"""Share of the traced part of the window in which no kernel or copy ran
on the card (the union of their intervals is the busy time)."""
UNIT = "%"
MOVES = "throughput"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    return (1.0 - p.busy_s() / p.window_s) * 100.0
