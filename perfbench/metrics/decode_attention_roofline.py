"""Decode attention's share of its roofline: one query token a row over
the cache slots valid at its step (the split kernel and, where it runs,
the combine kernel make one call; calls come layer by layer, step by
step)."""
from perfbench.lib import flops
from perfbench.lib.roofline import share

UNIT = "%"
MOVES = "throughput"
KERNELS = ("decode_split_kernel", "decode_combine_kernel")
CALLS = ("decode_split_kernel",)


def read(ctx):
    m = ctx.model
    L = m["num_layers"]

    def least(rows, i):
        step = (i // L) % ctx.steps
        return flops.decode_attention(rows, m["num_heads"],
                                      m["num_kv_heads"], m["head_dim"],
                                      ctx.prompt_len + step + 1)
    return share(ctx, "decode_attention_roofline", KERNELS, CALLS,
                 L * ctx.steps, least)
