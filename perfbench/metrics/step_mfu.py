"""The whole chain's share of the bf16 peak: model FLOPs (2 x parameters
x tokens, for the real rows a dispatch served, padding left out) over the
dispatches' summed execution time x 989e12; over the dispatches that
ended before the traced part of the window."""
from perfbench.lib import flops, hw

UNIT = "%"
MOVES = "throughput"


def read(ctx):
    if not ctx.dispatches:
        return None
    work = sum(flops.model_flops(ctx.n_params,
                                 d.rows * ctx.tokens_per_request())
               for d in ctx.dispatches)
    busy = sum(d.exec_s for d in ctx.dispatches)
    return work / (busy * hw.PEAK_FLOPS_BF16) * 100.0
