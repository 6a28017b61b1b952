"""Share of the differentiated attention calls that the kernel route
took: the program's counter ``attn.kernel.calls`` over it plus
``attn.chunked.calls`` (``models.attention``, one count a call). A
program without either counter reads nothing."""
from portbench.lib import program


def read(run):
    kernel = program.counter(run, "attn.kernel.calls")
    chunked = program.counter(run, "attn.chunked.calls")
    if kernel is None and chunked is None:
        return None
    kernel, chunked = kernel or 0.0, chunked or 0.0
    return 100.0 * kernel / (kernel + chunked)
