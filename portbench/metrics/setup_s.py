"""Seconds from the harness's start to the window's: imports, the
kernel library's load (its build in a fresh checkout), inputs and
weights from the seed, and the warm-up chapters."""


def read(run):
    return run.setup_s
