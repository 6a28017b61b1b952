"""Synthetic data (the port's own copy of the image part of
``repro.data`` and of its Markov LM prompts).

Deterministic class-prototype generators: each class has a smooth
random prototype; samples are ``clip(proto + noise)``. ``mnist_like`` is
close to linearly separable (like MNIST); ``cifar_like`` uses heavier
noise and class-overlapping prototypes. Everything here is numpy, and
every array is bit-identical to what the reference's functions of the
same name return for the same arguments (the port's tests check it).

Streaming sources follow the ``Source`` protocol: ``sample(split, n,
seed)`` is a pure function of its arguments, so a serving-traffic
generator regenerates its payloads without communication.
``PrototypeSource`` is the generator behind ``mnist_like``/``cifar_like``;
``ArraySource`` adapts materialized arrays (a task's test split) to the
same protocol. ``MarkovLM``/``lm_batches`` give the LM serving path's
prompts. The real-text ``TextSource`` waits for the LM training slice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Protocol, Tuple, runtime_checkable

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageTask:
    x_train: np.ndarray      # (N, D) float32 in [0, 1]
    y_train: np.ndarray      # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    dim: int


@runtime_checkable
class Source(Protocol):
    """Minimal streaming-source protocol.

    ``sample(split, n, seed)`` returns ``(x, y)`` with ``x`` of shape
    (n, dim) float32 in [0, 1] and ``y`` (n,) int32, and MUST be a pure
    function of ``(split, n, seed)``. ``split`` is a free-form label
    ("train" / "test" / "serve" / ...) that seeds an independent stream
    per consumer.
    """
    num_classes: int
    dim: int

    def sample(self, split: str, n: int, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]: ...


def _split_rng(seed, split: str, stream_seed: int):
    """Deterministic per-(seed, split, stream) generator: the split label
    is folded in bytewise so distinct labels give independent streams."""
    return np.random.default_rng(
        [int(seed), int(stream_seed)] + list(split.encode("utf-8")))


def _smooth_noise(rng, n, side, ch, scale):
    """Low-frequency noise: upsampled coarse grid (structured, image-like)."""
    coarse = rng.normal(size=(n, ch, side // 4, side // 4)) * scale
    up = coarse.repeat(4, axis=2).repeat(4, axis=3)
    return up.reshape(n, -1)


@dataclasses.dataclass(frozen=True)
class PrototypeSource:
    """The class-prototype generator behind ``mnist_like``/``cifar_like``
    as a streaming ``Source``.

    ``task(n_train, n_test)`` threads one rng through protos -> train ->
    test; ``sample(split, n, seed)`` draws a fresh deterministic batch
    from the SAME prototypes for any (split, seed).
    """
    seed: int
    side: int
    ch: int
    num_classes: int
    proto_scale: float
    noise_scale: float
    overlap: bool
    max_shift: int = 3

    @property
    def dim(self) -> int:
        return self.side * self.side * self.ch

    def _protos(self, rng):
        """Class prototypes; consumes ``rng`` in the reference's order
        (bit-compatibility depends on it)."""
        protos = _smooth_noise(rng, self.num_classes, self.side, self.ch,
                               self.proto_scale)
        if self.overlap:
            # mix prototypes so classes share structure (harder task)
            mix = rng.dirichlet(np.ones(self.num_classes) * 0.4,
                                size=self.num_classes)
            protos = mix @ protos
        return protos.reshape(self.num_classes, self.ch, self.side,
                              self.side)

    @functools.cached_property
    def _protos_cached(self):
        return self._protos(np.random.default_rng(self.seed))

    def _draw(self, protos_img, n, rng):
        y = rng.integers(0, self.num_classes, size=n).astype(np.int32)
        x = protos_img[y]
        if self.max_shift:
            # translation jitter (MNIST-style position variance)
            dx = rng.integers(-self.max_shift, self.max_shift + 1, size=n)
            dy = rng.integers(-self.max_shift, self.max_shift + 1, size=n)
            x = np.stack([np.roll(np.roll(im, a, axis=1), b, axis=2)
                          for im, a, b in zip(x, dx, dy)])
        x = x.reshape(n, self.dim)
        x = x + _smooth_noise(rng, n, self.side, self.ch, self.noise_scale)
        x = x + rng.normal(size=(n, self.dim)) * self.noise_scale * 0.5
        x = 1.0 / (1.0 + np.exp(-x))                     # into [0, 1]
        return x.astype(np.float32), y

    def task(self, n_train, n_test) -> ImageTask:
        """The fixed-size task: protos, train and test all drawn from ONE
        threaded rng."""
        rng = np.random.default_rng(self.seed)
        protos_img = self._protos(rng)
        x_tr, y_tr = self._draw(protos_img, n_train, rng)
        x_te, y_te = self._draw(protos_img, n_test, rng)
        return ImageTask(x_tr, y_tr, x_te, y_te, self.num_classes,
                         self.dim)

    def sample(self, split: str, n: int, seed: int = 0):
        """Fresh deterministic draw per (split, seed): same prototypes,
        independent noise/label stream."""
        return self._draw(self._protos_cached, n,
                          _split_rng(self.seed, split, seed))


@dataclasses.dataclass(frozen=True)
class ArraySource:
    """Materialized arrays as a ``Source``: ``sample`` draws a
    deterministic-with-replacement subset per (split, seed)."""
    x: np.ndarray
    y: np.ndarray
    num_classes: int

    @property
    def dim(self) -> int:
        return int(self.x.shape[-1])

    def sample(self, split: str, n: int, seed: int = 0):
        idx = _split_rng(0, split, seed).integers(0, len(self.x), size=n)
        return (np.asarray(self.x)[idx],
                np.asarray(self.y)[idx].astype(np.int32))


def source_of(task: ImageTask, split: str = "test") -> ArraySource:
    """A task's train/test arrays as a streaming ``Source`` (the default
    request-payload source for ``repro_torch.serve``)."""
    if split == "train":
        return ArraySource(task.x_train, task.y_train, task.num_classes)
    return ArraySource(task.x_test, task.y_test, task.num_classes)


def mnist_source(seed=0) -> PrototypeSource:
    """The generator behind ``mnist_like`` as a streaming ``Source``."""
    return PrototypeSource(seed, side=28, ch=1, num_classes=10,
                           proto_scale=2.0, noise_scale=0.8,
                           overlap=False, max_shift=4)


def cifar_source(seed=0) -> PrototypeSource:
    """The generator behind ``cifar_like`` as a streaming ``Source``."""
    return PrototypeSource(seed + 7, side=32, ch=3, num_classes=10,
                           proto_scale=1.0, noise_scale=0.9,
                           overlap=True, max_shift=3)


def mnist_like(seed=0, n_train=6000, n_test=1000):
    """28x28x1, 10 classes, separable but not linearly (MNIST stand-in)."""
    return mnist_source(seed).task(n_train, n_test)


def cifar_like(seed=0, n_train=6000, n_test=1000):
    """32x32x3, 10 classes, overlapping prototypes + heavy noise."""
    return cifar_source(seed).task(n_train, n_test)


# ---------------------------------------------------------------------------
# Language modelling (synthetic Markov corpus): the prompts of the LM
# serving path
# ---------------------------------------------------------------------------

class MarkovLM:
    """First-order Markov chain with sparse transitions + Zipf marginal."""

    def __init__(self, vocab, seed=0, branching=32):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = branching
        # each token can transition to `branching` successors
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        w = rng.pareto(1.2, size=(vocab, branching)) + 0.05
        self.probs = (w / w.sum(1, keepdims=True)).astype(np.float64)

    def sample(self, batch, seq_len, seed):
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len), np.int32)
        tok = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len):
            out[:, t] = tok
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[k]) for k in tok])
            tok = self.succ[tok, choice]
        return out


def lm_batches(vocab, batch, seq_len, steps, seed=0):
    """Yields (batch, seq_len + 1) int32 token blocks for `steps` steps
    (the chain has ``min(vocab, 4096)`` states; tokens are taken
    ``% vocab``)."""
    chain = MarkovLM(min(vocab, 4096), seed)
    for s in range(steps):
        yield chain.sample(batch, seq_len + 1, seed * 100003 + s) % vocab
