"""The negatives' and the trainer's key stream, worked out again.

A frozen copy of ``src/repro_torch/core/rng.py::TorchKey`` (the rule, not
an import): a key is the path of ``fold_in`` / ``split`` steps from a
seed, and each draw seeds a fresh CPU ``torch.Generator`` from a SHA-256
of the path's ``repr``. The reference draws the program's epoch
permutations, wrong labels, AdaptiveNEG samples and token corruptions
from it, so both sides take the same random numbers without the
reference reading anything the program made.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch


class Key:
    __slots__ = ("path",)

    def __init__(self, seed: int, *, _path: Tuple = None):
        self.path = (("seed", int(seed)),) if _path is None else _path

    def _child(self, step) -> "Key":
        return Key(0, _path=self.path + (step,))

    def fold_in(self, data: int) -> "Key":
        return self._child(("fold", int(data)))

    def split(self, n: int):
        return [self._child(("split", int(n), i)) for i in range(n)]

    def generator(self) -> torch.Generator:
        digest = hashlib.sha256(repr(self.path).encode()).digest()
        return torch.Generator().manual_seed(
            int.from_bytes(digest[:8], "little") >> 1)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator())

    def randint(self, shape, low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator())

    def bernoulli(self, shape, p: float) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator(),
                          dtype=torch.float32) < p

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        """Gumbel-max along the last axis, the uniforms drawn on the CPU
        and moved to the logits' device."""
        u = torch.rand(tuple(logits.shape), generator=self.generator(),
                       dtype=torch.float32).to(logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() + gumbel, dim=-1)
