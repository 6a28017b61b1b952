"""Kernel impl registry: named implementations per op with a platform
predicate, as ``repro.kernels.registry`` has them, for the three ops of
the port: ``ff_dense``, ``flash_attention`` and ``mamba2_ssd``.

Impl contracts:
  ff_dense         ``fn(x, w, b, *, norm) -> (y, g)``, differentiable
                   with respect to x, w and b; an impl registered
                   ``tunable`` (the CUDA kernel) also takes ``tile=(bn,
                   S)``, an autotuned tile, passed only when there is
                   one;
  flash_attention  ``fn(q, k, v, *, causal, window) -> out``;
  mamba2_ssd       ``fn(xbar, dA, b, c, *, chunk) -> (y, hT)``.

``"auto"`` resolves by the platform of the operands' device
(``tensor.device.type``): the first registered impl that prefers it,
else the fallback. On ``"cuda"`` that is the hand-written kernel (for
``ff_dense`` the kernel pair ``ff_dense_vjp`` / ``ff_dense_norm_vjp``:
the forward kernel, with the backward kernel as its gradient); on the
CPU the plain oracle. ``impl="cuda"`` on a CPU tensor raises. Unknown
names raise ``ValueError`` listing the registered choices. The tuning
table (``kernels.autotune``) is read by ``ops``, not here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.kernels import ff_dense_vjp, flash_attention as fa
from repro_torch.kernels import mamba2_ssd as ssd, ref


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One named implementation of an op; ``preferred(platform)`` True
    makes it ``"auto"``'s choice on that platform. ``tunable``: the
    autotuner sweeps its tiles (its fn honors ``tile=``)."""
    name: str
    fn: Callable
    preferred: Callable[[str], bool]
    tunable: bool = False


class KernelRegistry:
    """name -> KernelImpl for one op, with ``"auto"`` resolution."""

    def __init__(self, op: str, fallback: Optional[str] = None):
        self.op = op
        self.fallback = fallback
        self._entries = {}

    def register(self, name, fn, *, preferred=None, tunable=False,
                 overwrite=False):
        if name == "auto":
            raise ValueError(f"'auto' is the {self.op} resolver keyword, "
                             "not a registrable impl name")
        if not overwrite and name in self._entries:
            raise ValueError(
                f"{self.op} impl {name!r} already registered "
                "(pass overwrite=True to replace)")
        if preferred is None:
            preferred = lambda platform: False          # noqa: E731
        impl = KernelImpl(name, fn, preferred, tunable)
        self._entries[name] = impl
        return impl

    def unregister(self, name):
        """Remove an impl (no-op if absent): tests and experiments."""
        self._entries.pop(name, None)

    def get(self, name) -> KernelImpl:
        try:
            return self._entries[name]
        except KeyError:
            raise ValueError(
                f"unknown {self.op} impl {name!r}; expected one of "
                f"{' | '.join(self.choices())}") from None

    def resolve(self, platform) -> KernelImpl:
        """``"auto"``: first registered impl preferring ``platform``,
        else the fallback."""
        for impl in self._entries.values():
            if impl.preferred(platform):
                return impl
        return self.get(self.fallback)

    def lookup(self, impl, platform) -> KernelImpl:
        """The impl an ``impl=`` argument names for operands on
        ``platform``."""
        return self.resolve(platform) if impl == "auto" else self.get(impl)

    def names(self):
        return tuple(sorted(self._entries))

    def choices(self):
        """Valid ``impl=`` strings, for error messages."""
        return ("auto",) + self.names()

    def tunable_names(self):
        return tuple(n for n in self.names() if self._entries[n].tunable)

    def __contains__(self, name):
        return name in self._entries


def _on_cuda(platform):
    return platform == "cuda"


def _needs_cuda(op, t):
    if t.device.type != "cuda":
        raise ValueError(f"{op} impl 'cuda' needs CUDA tensors, got "
                         f"{t.device}; use impl='ref' (or 'auto') there")


ff_dense = KernelRegistry("ff_dense", fallback="ref")
flash_attention = KernelRegistry("flash_attention", fallback="ref")
mamba2_ssd = KernelRegistry("mamba2_ssd", fallback="ref")


def _ff_dense_cuda(x, w, b, *, norm, tile=None):
    _needs_cuda("ff_dense", x)
    fused = (ff_dense_vjp.ff_dense_norm_vjp if norm
             else ff_dense_vjp.ff_dense_vjp)
    return fused(x, w, b, tile)


def _ff_dense_ref(x, w, b, *, norm):
    if norm:
        return ref.ff_dense_norm_ref(x, w, b)
    return ref.ff_dense_ref(x, w, b)


def _flash_attention_cuda(q, k, v, *, causal, window):
    _needs_cuda("flash_attention", q)
    return fa.flash_attention(q, k, v, causal=causal, window=window)


def _mamba2_ssd_cuda(xbar, dA, b, c, *, chunk):
    _needs_cuda("mamba2_ssd", xbar)
    return ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk)


ff_dense.register("cuda", _ff_dense_cuda, preferred=_on_cuda, tunable=True)
ff_dense.register("ref", _ff_dense_ref)
flash_attention.register("cuda", _flash_attention_cuda, preferred=_on_cuda)
flash_attention.register("ref", ref.flash_attention_ref)
mamba2_ssd.register("cuda", _mamba2_ssd_cuda, preferred=_on_cuda)
mamba2_ssd.register("ref", ref.mamba2_ssd_ref)
