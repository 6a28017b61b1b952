"""Dispatch layer: model code calls the port's kernels from here.

  impl="auto"  the registry's choice for the operands' device: the CUDA
               kernel on a CUDA tensor, the plain oracle on a CPU one.
  impl="cuda"  the hand-written kernel; raises on a CPU tensor.
  impl="ref"   the plain PyTorch oracle, on any device.

There is no fallback: on a CUDA tensor ``"auto"`` is the kernel, and a
failed build or launch raises. Unknown impls raise ``ValueError``
listing the registered choices. (The reference's tuning-table lookup
waits for the autotuner's port.)
"""
from __future__ import annotations

from repro_torch.kernels import registry


def ff_dense(x, w, b, *, impl="auto", norm=False):
    """y = relu(x @ w + b), g = sum(y^2, -1); with ``norm=True`` y comes
    back length-normalized and g stays the raw goodness."""
    if impl == "auto":
        kimpl = registry.ff_dense.resolve(x.device.type)
    else:
        kimpl = registry.ff_dense.get(impl)
    return kimpl.fn(x, w, b, norm=norm)
