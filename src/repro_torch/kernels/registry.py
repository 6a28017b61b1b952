"""Kernel impl registry: named implementations per op with a platform
predicate, as ``repro.kernels.registry`` has them. Only ``ff_dense`` is
ported so far.

Impl contract: ``fn(x, w, b, *, norm) -> (y, g)``, differentiable with
respect to x, w and b.

``"auto"`` resolves by the platform of the operands' device
(``tensor.device.type``): the first registered impl that prefers it,
else the fallback. On ``"cuda"`` that is the hand-written kernel pair
(``ff_dense_vjp`` / ``ff_dense_norm_vjp``: the forward kernel, with the
backward kernel as its gradient); on the CPU the plain oracle, which
autograd differentiates. Unknown names raise ``ValueError`` listing the
registered choices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.kernels import ff_dense_vjp, ref


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One named implementation of an op; ``preferred(platform)`` True
    makes it ``"auto"``'s choice on that platform."""
    name: str
    fn: Callable
    preferred: Callable[[str], bool]


class KernelRegistry:
    """name -> KernelImpl for one op, with ``"auto"`` resolution."""

    def __init__(self, op: str, fallback: Optional[str] = None):
        self.op = op
        self.fallback = fallback
        self._entries = {}

    def register(self, name, fn, *, preferred=None, overwrite=False):
        if name == "auto":
            raise ValueError(f"'auto' is the {self.op} resolver keyword, "
                             "not a registrable impl name")
        if not overwrite and name in self._entries:
            raise ValueError(
                f"{self.op} impl {name!r} already registered "
                "(pass overwrite=True to replace)")
        if preferred is None:
            preferred = lambda platform: False          # noqa: E731
        impl = KernelImpl(name, fn, preferred)
        self._entries[name] = impl
        return impl

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

    def names(self):
        return tuple(sorted(self._entries))

    def choices(self):
        """Valid ``impl=`` strings, for error messages."""
        return ("auto",) + self.names()


ff_dense = KernelRegistry("ff_dense", fallback="ref")


def _on_cuda(platform):
    return platform == "cuda"


def _ff_dense_cuda(x, w, b, *, norm):
    if x.device.type != "cuda":
        raise ValueError(f"ff_dense impl 'cuda' needs CUDA tensors, got "
                         f"{x.device}; use impl='ref' (or 'auto') there")
    fused = (ff_dense_vjp.ff_dense_norm_vjp if norm
             else ff_dense_vjp.ff_dense_vjp)
    return fused(x, w, b)


def _ff_dense_ref(x, w, b, *, norm):
    if norm:
        return ref.ff_dense_norm_ref(x, w, b)
    return ref.ff_dense_ref(x, w, b)


ff_dense.register("cuda", _ff_dense_cuda, preferred=_on_cuda)
ff_dense.register("ref", _ff_dense_ref)
