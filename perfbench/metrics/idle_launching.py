"""Share of the traced part of the window in which no kernel or copy ran
on the card while a ``step@`` range was open on the host: the card
waiting on the host's launches inside a chain step.  Disjoint from
``idle_uploading`` and ``idle_in_runtime``; the three sum to at most
``device_idle`` (``perfbench/lib/ranges.py``).  None where the program
opens no such range."""
from perfbench.lib.ranges import idle_split

UNIT = "%"
MOVES = "throughput"


def read(ctx):
    split = idle_split(ctx)
    return None if split is None else split["launching"]
