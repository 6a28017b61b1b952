"""Share of the (q, k) pairs that the chunked attention route computes
which its mask lets through: the program's counters
``attn.chunked.visible_pairs`` over ``attn.chunked.pairs`` (from
shapes, once per call)."""
from portbench.lib import program


def read(run):
    pairs = program.counter(run, "attn.chunked.pairs")
    seen = program.counter(run, "attn.chunked.visible_pairs")
    if not pairs or seen is None:
        return None
    return 100.0 * seen / pairs
