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
    kimpl = registry.ff_dense.lookup(impl, x.device.type)
    return kimpl.fn(x, w, b, norm=norm)


def flash_attention(q, k, v, *, causal=True, window=None, impl="auto"):
    """Blockwise attention: q (B, Sq, H, hd), k and v (B, Sk, KV, hd) ->
    (B, Sq, H, hd) in q's dtype (GQA, causal and/or sliding window)."""
    kimpl = registry.flash_attention.lookup(impl, q.device.type)
    return kimpl.fn(q, k, v, causal=causal, window=window)


def mamba2_ssd(xbar, dA, b, c, *, chunk=128, impl="auto"):
    """Chunked SSD scan over f32 xbar (B, S, H, hd), dA (B, S, H), b and
    c (B, S, N) -> (y (B, S, H, hd), hT (B, H, hd, N)), both f32."""
    kimpl = registry.mamba2_ssd.lookup(impl, xbar.device.type)
    return kimpl.fn(xbar, dA, b, c, chunk=chunk)
