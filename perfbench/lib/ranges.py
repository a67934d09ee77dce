"""The program's own ranges in the device trace, and the card's idle time
split by which of them was open.

The program opens a profiler range, on the host clock of the device
trace, around three pieces of a chain dispatch (``obs/trace.py``'s
scopes): ``exec@<node>`` around its execution on the executor,
``upload@<node>`` around the move of its input to the card, and
``step@<node>:<op>`` around each step of the chain (``op`` is the step's
function, such as ``yi_9b_prefill`` or ``yi_9b_decode``).  A program
without these scopes (no ``repro_torch.obs.trace.scope``) leaves none in
the trace, and every reader built on this module then returns None.  A
program with them that ran no dispatch in the traced part (the profiler's
start can stall past the window's last arrival) has idle shares all the
same: no range was open."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]
KINDS = ("exec", "upload", "step")


def program(p) -> Dict[str, List[Tuple[str, float, float]]]:
    """The program's ranges in profile ``p`` by kind: (name, start,
    end), host clock, in the trace's order."""
    out: Dict[str, List[Tuple[str, float, float]]] = {k: [] for k in KINDS}
    prefixes = tuple(f"{k}@" for k in KINDS)
    for i, name in enumerate(p.host_names):
        if name.startswith(prefixes):
            out[name.partition("@")[0]].append(
                (name, float(p.host_start[i]), float(p.host_end[i])))
    return out


def program_has_scopes() -> bool:
    """Whether the program under test opens these ranges."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return False
    return hasattr(trace, "scope")


def union(ivs: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``ivs`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intersect(x: Sequence[Interval], y: Sequence[Interval]
              ) -> List[Interval]:
    """x ∩ y, both sorted and disjoint."""
    out: List[Interval] = []
    i = j = 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(x: Sequence[Interval], y: Sequence[Interval]) -> List[Interval]:
    """x − y, both sorted and disjoint."""
    out: List[Interval] = []
    j = 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(ivs: Iterable[Interval]) -> float:
    return sum(b - a for a, b in ivs)


def idle_split(ctx) -> Optional[Dict[str, float]]:
    """The traced part's idle time (no kernel or copy on the card), as
    shares in % of the traced part, split into disjoint parts:

    * ``launching``: a ``step@`` range is open (the card waits on the
      host's launches);
    * ``uploading``: an ``upload@`` range is open and no ``step@`` is;
    * ``in_runtime``: a request is outstanding (sent, its answer not yet
      complete) and no program range is open (batcher, executor
      pickup, callbacks, or a stall outside the dispatch);
    * ``rest``: the remainder (no request outstanding, or inside
      ``exec@`` but outside its upload and steps).

    None without a device trace or where the program opens no ranges."""
    p = ctx.profile
    if p is None or not program_has_scopes():
        return None
    r = program(p)
    lo, hi = p.start, p.stop
    step, up, ex = (union(((a, b) for _, a, b in r[k]), lo, hi)
                    for k in ("step", "upload", "exec"))
    out = union(((rec.sent, hi if rec.done is None else rec.done)
                 for rec in ctx.records if rec.sent is not None), lo, hi)
    gaps = p.gaps()
    launching = intersect(gaps, step)
    uploading = intersect(gaps, minus(up, step))
    in_runtime = intersect(gaps, minus(minus(out, ex), union(step + up,
                                                             lo, hi)))
    parts = {"launching": length(launching), "uploading": length(uploading),
             "in_runtime": length(in_runtime)}
    idle = length(gaps)
    parts["rest"] = idle - sum(parts.values())
    return {k: v / p.window_s * 100.0 for k, v in parts.items()}


def step_ms(ctx, op_suffix: str) -> Optional[float]:
    """Mean host duration in ms of the ``step@`` ranges whose op ends in
    ``op_suffix`` and that lie wholly inside the traced part; None where
    there are none."""
    p = ctx.profile
    if p is None:
        return None
    d = [b - a for name, a, b in program(p)["step"]
         if name.endswith(op_suffix) and p.start <= a and b <= p.stop]
    return sum(d) / len(d) * 1e3 if d else None
