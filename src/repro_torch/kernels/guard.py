"""The CUDA attention and SSD kernels refuse inputs that need a gradient.

Their wrappers write each result through raw pointers into a fresh
tensor, which has no ``grad_fn``: a loss built on it would still
backpropagate through the rest of the model, and the parameters that
reach it only through the kernel (attention's ``wq``/``wk``/``wv``, the
SSD's input projection through the scan) would silently get no
gradient. So on a CUDA tensor each wrapper calls ``refuse_autograd``
before it launches. The reference has no backward kernel for either
function; training goes through the plain versions (``impl="ref"``),
which autograd differentiates, and every forward that needs no gradient
runs under ``torch.no_grad()`` through the kernel.
"""
from __future__ import annotations

import torch


def records_grad(*operands):
    """True when autograd would record a call on ``operands``: grad mode
    is on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands)


def refuse_autograd(op, *operands):
    """The kernel writes its result through raw pointers, so the result
    has no ``grad_fn``: a gradient through it would be dropped without a
    word. Refuse instead, naming the differentiable route. (The reference
    has no backward kernel for attention or the SSD either; gradients go
    through the plain versions, which autograd differentiates.)"""
    if records_grad(*operands):
        raise RuntimeError(
            f"{op}'s CUDA kernel has no backward: an input requires grad "
            f"under autograd, and the kernel's result would drop it. Call "
            f"with impl=\"ref\" (the plain version, differentiable) to "
            f"train through it, or under torch.no_grad() to launch the "
            f"kernel")
