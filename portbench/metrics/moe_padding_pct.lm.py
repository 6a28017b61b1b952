"""Rows the expert GEMMs computed beyond the (token, slot) pairs that
landed on the card's experts, in % of those pairs: 100 x (``moe.rows`` /
``moe.pairs`` - 1), the program's counters over the window."""
from portbench.lib import program


def read(run):
    pairs = program.counter(run, "moe.pairs")
    rows = program.counter(run, "moe.rows")
    if not pairs or rows is None:
        return None
    return 100.0 * (rows / pairs - 1.0)
