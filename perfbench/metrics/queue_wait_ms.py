"""Mean executor queue wait of a request at the chain: the ``queue_s`` of
its ``exec@`` span (the time its dispatch waited for the GPU worker),
over the requests whose dispatch ended before the traced part of the
window (the profiler slows the host)."""
UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    if not ctx.request_spans:
        return None
    return sum(r[0] for r in ctx.request_spans) / len(
        ctx.request_spans) * 1e3
