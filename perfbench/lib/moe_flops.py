"""The least time of a MoE layer's routed expert products, at a call's
shapes (the benchmark's own arithmetic, beside ``flops.py``: later changes
to the program cannot move it).

What is counted is the work the call needs, whatever implements it: each
of ``rows`` tokens through its ``k`` experts' ``mats`` matrices of D x F,
2 operations a multiply-add; the k experts' matrices read once, the
tokens read once and the combined rows written once.  A call touches at
least k experts, exactly k at one row: above one row its rows may route
to more, so the bytes are a lower bound there and the share read against
them can only come out low, never above what the call could reach.  The
router, the sort and the combine are not counted."""
from __future__ import annotations

from typing import Dict

from perfbench.lib import flops


def moe_layers(model: Dict) -> int:
    """MoE layers of a configuration's ``model``: past its
    ``first_k_dense`` dense layers, the last of every
    ``moe_layer_period``."""
    if not model.get("num_experts"):
        return 0
    first = model.get("first_k_dense", 0)
    period = model.get("moe_layer_period", 1)
    return sum(1 for layer in range(first, model["num_layers"])
               if (layer - first) % period == period - 1)


def expert_products(rows: int, d_model: int, d_ff: int, k: int,
                    mats: int = 3, elem: int = 2) -> Dict[str, float]:
    """One call's routed expert products over ``rows`` tokens, top ``k``:
    2 * rows * k * mats * D * F operations; k * mats * D * F weights and
    2 * rows * D activations of ``elem`` bytes."""
    ops = 2.0 * rows * k * mats * d_model * d_ff
    nbytes = elem * (k * mats * d_model * d_ff + 2 * rows * d_model)
    return flops.least_time(ops, nbytes, "bfloat16")
