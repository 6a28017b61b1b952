"""The card's most allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in
GiB, on the fullest card."""


def read(run):
    return run.peak_bytes / 2 ** 30
