"""Share of the window in the MoE's routing and data movement, not its
experts: the summed CUDA-event time of the ``moe.router``,
``moe.dispatch`` (the sort, the segments' ends, the rows' gather) and
``moe.combine`` spans."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("moe.router", "moe.dispatch",
                                      "moe.combine"))
