"""Inputs from the seed: frozen numpy copies of the program's generators.

``mnist_like`` is ``src/repro_torch/data/__init__.py``'s
``PrototypeSource.task`` for ``mnist_source`` (class prototypes, a shift
of up to 4 pixels, smooth and pixel noise, a sigmoid), with the
per-image ``np.roll`` loop done by one gather: the same bits, faster.

``MarkovChain`` is that module's ``MarkovLM`` (``__init__`` copied: the
successor table and the Pareto weights from ``default_rng(seed)``), with
its token-by-token ``rng.choice`` loop replaced by an inverse-CDF draw
for all rows at once: the same chain, other bits, and 1000x faster at
the full vocabulary.

A traffic file's ``data`` block names the generator and its sizes;
``make(spec, seed)`` returns the arrays.
"""
from __future__ import annotations

import numpy as np

MNIST = dict(side=28, ch=1, num_classes=10, proto_scale=2.0,
             noise_scale=0.8, max_shift=4)


def _smooth_noise(rng, n, side, ch, scale):
    coarse = rng.normal(size=(n, ch, side // 4, side // 4)) * scale
    up = coarse.repeat(4, axis=2).repeat(4, axis=3)
    return up.reshape(n, -1)


def _shift(x, dx, dy):
    """``np.roll(np.roll(im, a, axis=1), b, axis=2)`` for every image:
    out[i, c, r, s] = x[i, c, (r - a_i) % side, (s - b_i) % side]."""
    n, _, side, _ = x.shape
    ar = np.arange(side)
    rows = (ar[None, :] - dx[:, None]) % side            # (n, side)
    cols = (ar[None, :] - dy[:, None]) % side
    x = np.take_along_axis(x, rows[:, None, :, None], axis=2)
    return np.take_along_axis(x, cols[:, None, None, :], axis=3)


def mnist_like(seed, n_train):
    """(x (n, 784) float32 in [0, 1], y (n,) int32): the training split
    of ``data.mnist_like(seed, n_train, ...)``, bit for bit."""
    p = MNIST
    side, ch, C, ns = p["side"], p["ch"], p["num_classes"], p["noise_scale"]
    rng = np.random.default_rng(seed)
    protos = _smooth_noise(rng, C, side, ch, p["proto_scale"])
    protos = protos.reshape(C, ch, side, side)
    y = rng.integers(0, C, size=n_train).astype(np.int32)
    x = protos[y]
    s = p["max_shift"]
    dx = rng.integers(-s, s + 1, size=n_train)
    dy = rng.integers(-s, s + 1, size=n_train)
    x = _shift(x, dx, dy).reshape(n_train, side * side * ch)
    x = x + _smooth_noise(rng, n_train, side, ch, ns)
    x = x + rng.normal(size=(n_train, side * side * ch)) * ns * 0.5
    x = 1.0 / (1.0 + np.exp(-x))
    return x.astype(np.float32), y


class MarkovChain:
    """First-order Markov chain with sparse transitions and a Zipf-like
    marginal, over the whole vocabulary."""

    def __init__(self, vocab, seed=0, branching=32):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = branching
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        w = rng.pareto(1.2, size=(vocab, branching)) + 0.05
        probs = w / w.sum(1, keepdims=True)
        self.cum = np.cumsum(probs, axis=1)

    def sample(self, batch, seq_len, seed):
        """(batch, seq_len) int32 token rows, a pure function of seed."""
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len), np.int32)
        tok = rng.integers(0, self.vocab, size=batch)
        u = rng.random(size=(seq_len, batch))
        last = self.branching - 1
        for t in range(seq_len):
            out[:, t] = tok
            choice = np.minimum((self.cum[tok] < u[t][:, None]).sum(1), last)
            tok = self.succ[tok, choice]
        return out


def make(spec, seed):
    """The arrays a traffic file's ``data`` block asks for, from
    ``seed``: ``{"x", "y"}`` for ``mnist_like``, ``{"tokens"}`` (rows of
    seq + 1 tokens) for ``markov_lm``."""
    kind = spec["generator"]
    if kind == "mnist_like":
        x, y = mnist_like(seed, spec["n_train"])
        return {"x": x, "y": y}
    if kind == "markov_lm":
        chain = MarkovChain(spec["vocab"], seed)
        return {"tokens": chain.sample(spec["rows"], spec["seq"] + 1,
                                       seed + 1)}
    raise ValueError(f"unknown generator {kind!r}")
