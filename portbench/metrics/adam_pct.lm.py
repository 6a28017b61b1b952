"""Share of the window in Adam's updates of the LM chapter tasks: the
summed CUDA-event time of the block steps' ``lm.adam`` spans and the
head steps' ``lm.head.adam``."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("lm.adam", "lm.head.adam"))
