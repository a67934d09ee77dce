"""The routed experts' grouped products in the decode steps: their share of
their roofline.  The least time the card could take for each decode call's
expert products (``perfbench/lib/moe_flops.py`` at one row: the k experts'
matrices read once, a row in and out; a call of more rows needs more, so
this never counts work a call need not do) over the device time of those
products' kernels, one kernel a weight matrix (``torch._grouped_mm``'s
CUTLASS kernel).

The calls are found in the device trace itself, in the order the kernels
ran (one stream): a layer runs its attention, then its MoE call, so the
grouped kernels after a decode attention kernel and before the next
attention kernel are one decode call, those after a flash attention
kernel one prefill call.  The prefill's calls are left out: which
experts, and so how many bytes, they need depends on routing the trace
does not show.  A call the traced part holds only in part (fewer kernels
than weight matrices) is left out.  None without a device trace, without
such a call, or for a configuration without experts."""
import sys

from perfbench.lib import moe_flops

UNIT = "%"
MOVES = "throughput"
#: name fragments of the grouped product's kernel
KERNELS = ("GroupProblemShape",)
#: of the attention kernels that open a layer: decode, prefill
DECODE_ATTENTION = ("decode_split_kernel",)
PREFILL_ATTENTION = ("flash_attention_kernel", "flash_wgmma_kernel",
                     "flash_pingpong_kernel")


def read(ctx):
    p = ctx.profile
    m = ctx.model
    if p is None or not moe_flops.moe_layers(m):
        return None
    mats = 3 if m.get("gated_mlp", True) else 2
    least = moe_flops.expert_products(
        1, m["d_model"], m.get("expert_d_ff") or m["d_ff"],
        m["num_experts_per_tok"], mats)["seconds"]
    t_min = t_dev = 0.0
    decode, call = False, []
    for k in sorted(p.kernels, key=lambda k: k.start) + [None]:
        opens = k is None or any(f in k.name for f in
                                 DECODE_ATTENTION + PREFILL_ATTENTION)
        if opens:
            if decode and len(call) == mats:
                t_min += least
                t_dev += sum(c.seconds for c in call)
            decode = k is not None and any(f in k.name
                                           for f in DECODE_ATTENTION)
            call = []
        elif any(f in k.name for f in KERNELS):
            call.append(k)
    if t_dev <= 0:
        return None
    print(f"expert_decode_roofline: least {t_min * 1e3:.6f} ms over device "
          f"{t_dev * 1e3:.6f} ms", file=sys.stderr)
    return t_min / t_dev * 100.0
