"""Mean host duration of the chain's prefill step: the ``step@<node>:<op>``
ranges whose op ends in ``_prefill`` (``obs/trace.py``'s scope around
each step of ``core/lowering.py``'s ``compose_steps``) that lie wholly
inside the traced part of the window.  The host is timed with the
profiler on, which slows it: compare between traced runs only;
``dispatch_ms``, read before the profiler starts, stays the unbiased
figure for the whole chain.  None where the program opens no such
range."""
from perfbench.lib.ranges import step_ms

UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    return step_ms(ctx, "_prefill")
