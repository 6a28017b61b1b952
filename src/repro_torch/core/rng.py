"""The trainer's random source: keys that fold and split like
``jax.random`` keys.

``jax.random``'s threefry bits cannot be drawn from a
``torch.Generator``, so the port does not try to reproduce them. It
keeps the reference's key discipline instead: every random draw of a
training run (initial params, epoch permutations, wrong labels,
AdaptiveNEG's sampling) comes from one key object, passed wherever the
reference passes its jax key and derived by the same ``fold_in`` /
``split`` chain. A ``TorchKey`` is the path of that chain; each draw
seeds a fresh CPU ``torch.Generator`` from a stable hash of the path,
so a draw is a pure function of the key (drawing twice from one key
gives the same numbers, as in JAX) and of nothing else.

The key interface, which the trainers rely on and which any other key
object (the parity tests' jax-backed key) provides too:

    fold_in(data) -> key        split(n) -> [key] * n
    permutation(n) -> (n,) int64 CPU tensor
    randint(shape, low, high) -> int CPU tensor in [low, high)
    normal(shape) -> float32 CPU tensor
    bernoulli(shape, p) -> bool CPU tensor, True with probability p
    categorical(logits) -> one index along the last axis of logits of any
                           rank (``(B, C)`` -> ``(B,)``, ``(B, S, V)`` ->
                           ``(B, S)``), on the logits' device

The random bits are drawn on the CPU; callers move them (``categorical``
moves its uniforms to the logits' device and forms the Gumbel noise
there).
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch


class TorchKey:
    """A random key: the seed and the fold_in/split path from it."""

    __slots__ = ("path",)

    def __init__(self, seed: int, *, _path: Tuple = None):
        self.path = (("seed", int(seed)),) if _path is None else _path

    def __repr__(self):
        return f"TorchKey{self.path}"

    def _child(self, step) -> "TorchKey":
        return TorchKey(0, _path=self.path + (step,))

    def fold_in(self, data: int) -> "TorchKey":
        return self._child(("fold", int(data)))

    def split(self, n: int):
        return [self._child(("split", int(n), i)) for i in range(n)]

    def generator(self) -> torch.Generator:
        """A fresh CPU generator seeded from a stable hash of the path
        (not Python's ``hash``, which varies between processes)."""
        digest = hashlib.sha256(repr(self.path).encode()).digest()
        return torch.Generator().manual_seed(
            int.from_bytes(digest[:8], "little") >> 1)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator())

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator())

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator(),
                           dtype=torch.float32)

    def bernoulli(self, shape, p: float) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator(),
                          dtype=torch.float32) < p

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        """One sample along the last axis of ``logits`` (Gumbel-max, as
        ``jax.random.categorical(..., axis=-1)`` draws it); -inf logits
        are never drawn."""
        u = torch.rand(tuple(logits.shape), generator=self.generator(),
                       dtype=torch.float32).to(logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() + gumbel, dim=-1)
