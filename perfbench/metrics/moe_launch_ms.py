"""Mean host duration of a MoE layer's call: the program's ``moe@`` ranges
(``obs/trace.scope`` around each ``moe_apply`` in
``models/transformer.py``) that lie wholly inside the traced part of the
window, prefill and decode calls alike.  Timed with the profiler on, so
compare traced runs only.  None where the program opens no such range."""
UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    d = [float(p.host_end[i] - p.host_start[i])
         for i, name in enumerate(p.host_names)
         if name.startswith("moe@") and p.start <= p.host_start[i]
         and p.host_end[i] <= p.stop]
    return sum(d) / len(d) * 1e3 if d else None
