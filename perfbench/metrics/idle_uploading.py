"""Share of the traced part of the window in which no kernel or copy ran
on the card while an ``upload@`` range (the move of a dispatch's input
to the card) was open and no ``step@`` range was.  None where the
program opens no such range."""
from perfbench.lib.ranges import idle_split

UNIT = "%"
MOVES = "throughput"


def read(ctx):
    split = idle_split(ctx)
    return None if split is None else split["uploading"]
