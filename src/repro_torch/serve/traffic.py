"""Deterministic open-loop traffic generators for the serving loop (the
port's copy of ``repro.serve.traffic``; numpy only, so the streams are
identical to the reference's for the same seed).

A traffic strategy shapes WHEN requests arrive and WHICH class each one
asks about; the payload pixels come from a ``data.Source``. Strategies
live in a ``strategies.Registry``: the serving loop does a registry
lookup, never a string-``if``.

Strategy signature (all builtins, and anything registered via
``register_traffic``):

    fn(rng, n, rate, num_classes) -> (gaps, classes)

``gaps`` is an (n,) float array of inter-arrival times in seconds at a
nominal mean rate of ``rate`` requests/second; ``classes`` is an (n,)
int32 array of requested class labels. Both must be pure functions of
the rng — ``RequestStream`` derives one rng per (seed, chunk) with
``data``'s seeding idiom, so a stream replays bit-identically from its
seed alone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch import data as data_lib
from repro_torch.core import strategies
from repro_torch.serve.queue import Request


@dataclasses.dataclass(frozen=True)
class TrafficStrategy:
    """One arrival/class-mix shape. ``fn(rng, n, rate, num_classes)``
    returns ``(gaps, classes)`` as documented in the module docstring."""
    name: str
    fn: Callable


traffic = strategies.Registry("traffic")


def register_traffic(name, fn, *, overwrite=False):
    """Register a traffic shape under ``name``."""
    return traffic.register(name, TrafficStrategy(name=name, fn=fn),
                            overwrite=overwrite)


# ---------------------------------------------------------------------------
# Builtins
# ---------------------------------------------------------------------------

def _uniform(rng, n, rate, num_classes):
    """Steady clock-tick arrivals, uniform class mix — the baseline."""
    gaps = np.full(n, 1.0 / rate)
    classes = rng.integers(0, num_classes, size=n).astype(np.int32)
    return gaps, classes


def _zipf(rng, n, rate, num_classes, *, alpha=1.1):
    """Poisson arrivals with a Zipf-skewed class mix: a few head classes
    dominate (the realistic serving distribution). The class->rank map
    is itself drawn from the rng, so different seeds skew different
    classes."""
    gaps = rng.exponential(1.0 / rate, size=n)
    p = 1.0 / np.arange(1, num_classes + 1) ** alpha
    p /= p.sum()
    ranks = rng.permutation(num_classes)
    classes = ranks[rng.choice(num_classes, size=n, p=p)].astype(np.int32)
    return gaps, classes


def _bursty(rng, n, rate, num_classes, *, burst=8.0, duty=0.25):
    """On/off bursts: a fraction ``duty`` of requests arrive in bursts
    at ``burst``x the nominal rate, the rest idle at the matching slower
    rate (mean rate stays ~``rate``) — the admission-control stressor."""
    idle_rate = rate * (1.0 - duty) / max(1.0 - duty / burst, 1e-9)
    in_burst = rng.random(n) < duty
    gaps = np.where(in_burst,
                    rng.exponential(1.0 / (rate * burst), size=n),
                    rng.exponential(1.0 / idle_rate, size=n))
    classes = rng.integers(0, num_classes, size=n).astype(np.int32)
    return gaps, classes


register_traffic("uniform", _uniform)
register_traffic("zipf", _zipf)
register_traffic("bursty", _bursty)


# ---------------------------------------------------------------------------
# Request stream: traffic shape x payload source -> Request sequence
# ---------------------------------------------------------------------------

class RequestStream:
    """Lazy, deterministic, unbounded request sequence.

    Requests are generated in chunks; chunk ``c`` uses an rng derived
    from ``(seed, "traffic", c)`` and a payload pool sampled from the
    source at ``(split="serve", seed=seed * 100003 + c)``. Each request's
    payload is drawn from the pool's examples of its requested class
    (so a zipf class skew skews the actual scored pixels), falling back
    to any pooled example for classes the pool missed.

    ``take(n)`` yields the next ``n`` ``(arrival_time, Request)`` pairs
    with arrival times accumulated from the gaps — an open-loop arrival
    process the serve loop replays against the wall clock.
    """

    CHUNK = 256

    def __init__(self, source: data_lib.Source, strategy: TrafficStrategy,
                 *, rate: float, num_classes: Optional[int] = None,
                 seed: int = 0):
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        self.source = source
        self.strategy = strategy
        self.rate = float(rate)
        self.num_classes = (int(num_classes) if num_classes is not None
                            else int(source.num_classes))
        self.seed = int(seed)
        self._chunk_i = 0
        self._pending = []          # reversed buffer of (t_arrival, Request)
        self._t = 0.0               # arrival clock (seconds since start)
        self._next_id = 0

    def _refill(self):
        c = self._chunk_i
        self._chunk_i += 1
        rng = np.random.default_rng([self.seed, 0x7AFF1C, c])
        gaps, classes = self.strategy.fn(rng, self.CHUNK, self.rate,
                                         self.num_classes)
        x, y = self.source.sample("serve", self.CHUNK * 2,
                                  seed=self.seed * 100003 + c)
        by_class = {k: list(np.flatnonzero(y == k)) for k in set(y.tolist())}
        out = []
        for gap, cls in zip(gaps, classes):
            pool = by_class.get(int(cls))
            if pool:
                j = pool[rng.integers(0, len(pool))]
            else:                       # pool missed this class entirely
                j = int(rng.integers(0, len(y)))
            self._t += float(gap)
            out.append((self._t, Request(id=self._next_id, x=x[j],
                                         label=int(y[j]),
                                         t_arrival=self._t)))
            self._next_id += 1
        self._pending = out[::-1]

    def take(self, n: int):
        """Next ``n`` (arrival_time, Request) pairs, arrival times
        strictly accumulating across calls."""
        out = []
        while len(out) < n:
            if not self._pending:
                self._refill()
            out.append(self._pending.pop())
        return out
