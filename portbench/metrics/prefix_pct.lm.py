"""Share of the window in the frozen no-grad forwards: the summed
CUDA-event time of the block steps' ``lm.prefix`` spans (blocks < k)
and the head steps' ``lm.head.prefix`` (every block)."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("lm.prefix", "lm.head.prefix"))
