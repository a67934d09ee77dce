"""Mean execution time of a chain dispatch on its executor (``exec_s``):
the whole batch's host time, ending at the boundary copy's synchronise
for a batched dispatch and at the last launch for a per-row one; over the
dispatches that ended before the traced part of the window."""
UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    if not ctx.dispatches:
        return None
    return sum(d.exec_s for d in ctx.dispatches) / len(ctx.dispatches) * 1e3
