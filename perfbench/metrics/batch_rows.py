"""Requests per chain dispatch, from the ``exec@`` spans' batch links, over
the dispatches that ended before the traced part of the window."""
UNIT = "rows/dispatch"
MOVES = "throughput"


def read(ctx):
    if not ctx.dispatches:
        return None
    return sum(d.rows for d in ctx.dispatches) / len(ctx.dispatches)
