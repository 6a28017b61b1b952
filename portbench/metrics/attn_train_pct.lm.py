"""Share of the window in the differentiated attention of the trained
block, whichever route ran it: the summed CUDA-event time of the
chunked route's ``attn.chunked.fwd`` / ``attn.chunked.bwd`` spans and
the kernel route's ``attn.kernel.fwd`` / ``attn.kernel.bwd`` spans
(``models.attention``; each backward span between two autograd
hooks)."""
from portbench.lib import program


def read(run):
    return program.device_share(run, ("attn.chunked.fwd", "attn.chunked.bwd",
                                      "attn.kernel.fwd", "attn.kernel.bwd"))
