"""Operations and bytes that a kernel call needs, at the call's shapes, and
the least time the H100 could take for them (the benchmark's own copy of
the arithmetic: later changes to the program cannot move the yardstick).

What is counted is the work the function needs, whatever implements it:
each input byte read once, each output byte written once; for causal
attention only the causal pairs, for decode attention only the cache slots
that are valid at the step.  The least time is the larger of the
operations over the peak of their type and the bytes over HBM bandwidth;
``bound`` says which of the two set it.
"""
from __future__ import annotations

from typing import Dict

from perfbench.lib import hw


def least_time(flops: float, nbytes: float, peak: str) -> Dict[str, float]:
    t_ops = flops / hw.PEAKS[peak]
    t_bytes = nbytes / hw.HBM_BW
    return {"flops": flops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "bound": "operations" if t_ops > t_bytes else "bytes"}


def flash_attention(B: int, H: int, K: int, S: int, hd: int,
                    elem: int = 2) -> Dict[str, float]:
    """Causal self attention of S queries over S keys, GQA (H query heads
    over K key heads): QK^T and PV over the S(S+1)/2 causal pairs, 2
    operations a multiply-add; reads q, k, v, writes o."""
    pairs = S * (S + 1) / 2
    flops = 4.0 * B * H * pairs * hd
    nbytes = elem * B * S * hd * (2 * H + 2 * K)
    return least_time(flops, nbytes, "bfloat16")


def decode_attention(B: int, H: int, K: int, hd: int, valid: int,
                     elem: int = 2) -> Dict[str, float]:
    """One query token a row against ``valid`` cache slots: reads q, the
    valid slots' keys, values and int32 positions, writes o."""
    flops = 4.0 * B * H * valid * hd
    nbytes = B * (elem * H * hd * 2 + valid * (2 * elem * K * hd + 4))
    return least_time(flops, nbytes, "bfloat16")


def model_flops(n_params: int, tokens: int) -> float:
    """Model FLOPs of a forward pass: 2 x parameters x tokens processed."""
    return 2.0 * n_params * tokens
