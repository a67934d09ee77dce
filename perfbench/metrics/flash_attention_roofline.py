"""Flash attention's share of its roofline: causal self attention over the
prompt, one call a layer and prefill (bytes bound at these shapes)."""
from perfbench.lib import flops
from perfbench.lib.roofline import share

UNIT = "%"
MOVES = "throughput"
KERNELS = ("flash_attention_kernel", "flash_wgmma_kernel",
           "flash_pingpong_kernel")


def read(ctx):
    m = ctx.model

    def least(rows, i):
        return flops.flash_attention(rows, m["num_heads"],
                                     m["num_kv_heads"], ctx.prompt_len,
                                     m["head_dim"])
    return share(ctx, "flash_attention_roofline", KERNELS, KERNELS,
                 m["num_layers"], least)
