"""Share of the window in the chunked attention route under autograd
(``models.attention._chunked``): the summed CUDA-event time of its
``attn.chunked.fwd`` spans and of the ``attn.chunked.bwd`` spans that
two autograd hooks bound (its backward)."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("attn.chunked.fwd", "attn.chunked.bwd"))
