"""Median request latency: each request timed from when it was due until
its answer was complete; a failed or missing request counts as never
completing.  Read in the traced run, over the requests due at least 5 s
before its profiled part began (the profiler slows the host).  Not an
end-to-end metric: on this platform the host's speed differs from
process to process, and these tails amplify it past any bound."""
from perfbench.lib.stats import percentile

UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    lat = ctx.untraced_latencies()
    return percentile(lat, 50) * 1e3 if lat else None
