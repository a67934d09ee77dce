"""Mean host duration of one decode step of the chain: the
``step@<node>:<op>`` ranges whose op ends in ``_decode`` that lie wholly
inside the traced part of the window (see ``prefill_launch_ms``: timed
with the profiler on, so compare between traced runs only).  None where
the program opens no such range."""
from perfbench.lib.ranges import step_ms

UNIT = "ms"
MOVES = "throughput"


def read(ctx):
    return step_ms(ctx, "_decode")
