"""Kernel launch calls on the host made inside the program's ``moe@``
ranges (a MoE layer's call: router, sort, grouped expert products,
combine) in the traced part of the window, over the requests that
completed in it.  None where the program opens no such range or no
request completed."""
import numpy as np

from perfbench.lib.profile import LAUNCH_CALLS

UNIT = "launches/req"
MOVES = "throughput"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    ranges = sorted((float(p.host_start[i]), float(p.host_end[i]))
                    for i, name in enumerate(p.host_names)
                    if name.startswith("moe@"))
    n = ctx.requests_done_in_profile()
    if not ranges or not n:
        return None
    t = np.array([p.host_start[i] for i, name in enumerate(p.host_names)
                  if name in LAUNCH_CALLS], dtype=np.float64)
    starts = np.array([a for a, _ in ranges])
    ends = np.array([b for _, b in ranges])
    j = np.searchsorted(starts, t, side="right") - 1
    inside = (j >= 0) & (t <= ends[np.clip(j, 0, None)])
    return float(inside.sum()) / n
