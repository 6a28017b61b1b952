"""Dispatch layer: model code calls the port's kernels from here.

  impl="auto"  the registry's choice for the operands' device: the CUDA
               kernel on a CUDA tensor, the plain oracle on a CPU one.
               For ``ff_dense`` on CUDA operands, the tuning table's
               winner for the shape bucket when one is recorded
               (``kernels.autotune``; populate it with ``python -m
               repro_torch.kernels.autotune`` on the card): the kernel
               at its tuned (bn, S) tile, else at its default tile.
  impl="cuda"  the hand-written kernel, at the table's tuned tile where
               one is recorded; raises on a CPU tensor.
  impl="ref"   the plain PyTorch oracle, on any device; reads no table.

There is no fallback: on a CUDA tensor ``"auto"`` is the kernel, and a
failed build or launch raises. A poisoned table warns and gives the
default tile, never the plain version. CPU operands never read a table.
Unknown impls raise ``ValueError`` listing the registered choices.
"""
from __future__ import annotations

from repro_torch.kernels import autotune, registry


def _resolve_from_table(M, K, N, dtype, platform, norm, impl):
    if impl == "auto":
        entry = autotune.lookup("ff_dense", M, K, N, dtype, platform,
                                norm=norm)
        if entry is None:
            return registry.ff_dense.resolve(platform).name, None
        return entry["impl"], autotune.entry_tile(entry)
    if registry.ff_dense.get(impl).tunable:
        # a forced tunable impl still launches the tuned tile
        entry = autotune.lookup("ff_dense", M, K, N, dtype, platform,
                                norm=norm)
        return impl, autotune.entry_tile(entry) if entry else None
    return impl, None


def resolve_ff_dense(M, K, N, dtype, platform, norm, impl):
    """(impl name, tile or None) of an ``ff_dense`` call. Only
    ``platform="cuda"`` reads the tuning table, once per bucket and
    table path (memoized in ``autotune.RESOLVED``, so a call pays a
    tuple and a dict lookup); elsewhere it is the registry's choice with
    no tile."""
    if platform != "cuda":
        return registry.ff_dense.lookup(impl, platform).name, None
    memo = (M, K, N, dtype, norm, impl, autotune.table_path())
    hit = autotune.RESOLVED.get(memo)
    if hit is None:
        hit = autotune.RESOLVED[memo] = _resolve_from_table(
            M, K, N, dtype, platform, norm, impl)
    return hit


def ff_dense(x, w, b, *, impl="auto", norm=False):
    """y = relu(x @ w + b), g = sum(y^2, -1); with ``norm=True`` y comes
    back length-normalized and g stays the raw goodness."""
    name, tile = resolve_ff_dense(x.shape[0], x.shape[1], w.shape[1],
                                  x.dtype, x.device.type, norm, impl)
    kw = {} if tile is None else {"tile": tile}
    return registry.ff_dense.get(name).fn(x, w, b, norm=norm, **kw)


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
