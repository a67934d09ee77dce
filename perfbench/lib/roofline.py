"""A kernel's share of its roofline in the traced part of the window: the
least time the card could take for the calls the device trace holds (at
each call's shapes, from the cell's geometry) over the device time those
calls took.  Only the dispatches that began inside the traced part count,
each with the kernels it launched."""
from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence


def share(ctx, name: str, kernels: Sequence[str], calls: Sequence[str],
          per_row: int, least: Callable[[int, int], Dict[str, float]]
          ) -> Optional[float]:
    """``kernels``: name fragments of every kernel a call runs; ``calls``:
    those of the one kernel each call runs once; ``per_row``: the calls
    one request makes; ``least(rows, i)``: the least time of the i-th call
    of a dispatch at ``rows`` rows a call.

    A batched dispatch makes ``per_row`` calls at its padded row count; a
    dispatch routed per row makes them once a request, one row a call.  A
    dispatch whose calls the trace holds only in part (it ran across an
    end of the traced part) fits neither count and is left out."""
    p = ctx.profile
    if p is None:
        return None
    by: Dict[int, list] = {}
    for k in p.kernels:
        if k.dispatch is not None and any(f in k.name for f in kernels):
            by.setdefault(k.dispatch, []).append(k)
    t_min = t_dev = 0.0
    bounds = set()
    for i, ks in by.items():
        d = p.dispatches[i]
        ks.sort(key=lambda k: k.start)
        n = sum(1 for k in ks if any(f in k.name for f in calls))
        if n == per_row:
            rows = d.bucket
        elif n == per_row * d.rows:
            rows = 1
        else:
            continue
        for j in range(n):
            lt = least(rows, j)
            t_min += lt["seconds"]
            bounds.add(lt["bound"])
        t_dev += sum(k.seconds for k in ks)
    if t_dev <= 0:
        return None
    print(f"{name}: least {t_min * 1e3:.6f} ms over device "
          f"{t_dev * 1e3:.6f} ms, bound by {'/'.join(sorted(bounds))}",
          file=sys.stderr)
    return t_min / t_dev * 100.0
