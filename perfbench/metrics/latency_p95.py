"""95th percentile of the same latencies as ``latency_p50``, over all the
requests it reads."""
from perfbench.lib.stats import percentile

UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    lat = ctx.untraced_latencies()
    return percentile(lat, 95) * 1e3 if lat else None
