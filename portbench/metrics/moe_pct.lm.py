"""Share of the window in the sigmoid-routed MoE (``models.mlp.
sigmoid_moe_apply``): the summed CUDA-event time of its ``moe.router``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared`` and
``moe.bwd`` spans (the backward between two autograd hooks) and the
block steps' ``moe.bias_update``. A program without them reads
nothing."""
from portbench.lib import program


def read(run):
    return program.device_share(run, (
        "moe.router", "moe.dispatch", "moe.experts", "moe.combine",
        "moe.shared", "moe.bwd", "moe.bias_update"))
