"""Share of the traced part of the window in which no kernel or copy ran
on the card while at least one request was outstanding (sent, its answer
not yet complete) and no program range (``exec@``, ``upload@``,
``step@``) was open: the batcher, the executor's pickup, the callbacks,
or a stall outside the dispatch.  What ``device_idle`` holds beyond this
and ``idle_launching`` and ``idle_uploading`` is idle time with no
request outstanding, or inside ``exec@`` but outside its upload and
steps.  None where the program opens no such range."""
from perfbench.lib.ranges import idle_split

UNIT = "%"
MOVES = "throughput"


def read(ctx):
    split = idle_split(ctx)
    return None if split is None else split["in_runtime"]
