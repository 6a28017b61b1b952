"""Share of the window in the head step's CE and its gradient
(``core.train.head_ce`` and ``grads_of``): the summed CUDA-event time
of the ``lm.head.ce`` spans."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("lm.head.ce",))
