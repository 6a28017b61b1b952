"""Thread-safe tracing core of the port (its own copy of
``repro.obs.trace``, with the same span names and semantics).

One ``Tracer`` owns one monotonic clock domain (``time.perf_counter``
anchored at construction), so spans recorded from the executor driver
thread, the serve loop, and the ``train_while_serve`` background
thread all land on a single comparable timeline. Producers record:

* ``span(name, **attrs)`` — a context manager for a timed region, or
  the manual ``add_span(name, t0, t1=None, **attrs)`` when the region
  does not nest lexically (the executor opens a task span before an
  asynchronous CUDA launch and closes it after
  ``torch.cuda.synchronize()``).
* ``event(name, **attrs)`` — an instantaneous marker (prefetch hit,
  retry, shed, version-vector violation, ...).
* ``counter(name, value)`` — an accumulating scalar (checkpoint /
  restore / recovery seconds, folding the executor's scattered
  resilience timers onto the tracer).

The default tracer is the module-level ``NOOP`` singleton: every hot
path calls through it unconditionally, and its methods are
constant-time attribute hits that allocate nothing, so an untraced run
pays only a few ``enabled``-flag checks. Producers that would do real
work just to *build* a span (formatting attrs, snapshotting queue
depths) must guard on ``tracer.enabled`` first.

``block_tasks`` is the asynchronous-launch knob: with it (the default)
a producer calls ``torch.cuda.synchronize()`` before closing each task
span, so span durations are real device time, at the cost of
serializing per-task overlap (an observer effect). With
``block_tasks=False`` spans measure the launch only.

This module imports nothing from the rest of the package, so every
``core``/``serve`` module can depend on it without import cycles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """A closed timed region on the tracer's clock (seconds since t0)."""
    name: str
    t0: float
    t1: float
    thread: str
    attrs: Dict[str, Any]

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Event:
    """An instantaneous marker on the tracer's clock."""
    name: str
    t: float
    thread: str
    attrs: Dict[str, Any]


class Tracer:
    """Collects spans/events/counters on one shared monotonic clock.

    Thread-safe: ``add_span``/``event``/``counter`` may be called
    concurrently from any thread; each record carries the recording
    thread's name (the Chrome exporter maps it to ``tid``).
    """

    enabled = True

    def __init__(self, *, block_tasks: bool = True,
                 meta: Optional[Dict[str, Any]] = None):
        self.block_tasks = block_tasks
        self.meta: Dict[str, Any] = dict(meta or {})
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.counters: Dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    # -- clock ------------------------------------------------------------
    def now(self) -> float:
        """Seconds since this tracer was created (monotonic)."""
        return time.perf_counter() - self._t0

    # -- recording --------------------------------------------------------
    def add_span(self, name: str, t0: float, t1: Optional[float] = None,
                 **attrs) -> Span:
        """Record a region [t0, t1] (both in ``now()`` time; t1 defaults
        to the current instant)."""
        if t1 is None:
            t1 = self.now()
        sp = Span(name, t0, t1, threading.current_thread().name, attrs)
        with self._lock:
            self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = self.now()
        try:
            yield self
        finally:
            self.add_span(name, t0, **attrs)

    def event(self, name: str, **attrs) -> Event:
        ev = Event(name, self.now(), threading.current_thread().name, attrs)
        with self._lock:
            self.events.append(ev)
        return ev

    def counter(self, name: str, value: float = 1.0) -> None:
        """Accumulate ``value`` onto the named counter."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    # -- reading ----------------------------------------------------------
    def span_count(self) -> int:
        with self._lock:
            return len(self.spans)

    def snapshot(self, *, start: int = 0) -> List[Span]:
        """A consistent copy of ``spans[start:]`` (appends-only list, so
        the slice is the spans recorded since ``span_count()`` returned
        ``start``)."""
        with self._lock:
            return list(self.spans[start:])

    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form consumed by the exporters and the analyzer."""
        with self._lock:
            return {
                "meta": dict(self.meta),
                "spans": [dataclasses.asdict(s) for s in self.spans],
                "events": [dataclasses.asdict(e) for e in self.events],
                "counters": dict(self.counters),
            }


class _NoopTracer:
    """Shared disabled tracer: the zero-overhead default.

    Records nothing; every method is a cheap constant. ``span()``
    returns one reusable null context manager (no allocation per
    call).
    """

    enabled = False
    block_tasks = False
    meta: Dict[str, Any] = {}
    spans: List[Span] = []
    events: List[Event] = []
    counters: Dict[str, float] = {}

    def __init__(self):
        self._null_cm = contextlib.nullcontext(self)

    def now(self) -> float:
        return 0.0

    def add_span(self, name, t0, t1=None, **attrs):
        return None

    def span(self, name, **attrs):
        return self._null_cm

    def event(self, name, **attrs):
        return None

    def counter(self, name, value=1.0):
        return None

    def span_count(self) -> int:
        return 0

    def snapshot(self, *, start: int = 0):
        return []

    def to_dict(self):
        return {"meta": {}, "spans": [], "events": [], "counters": {}}


NOOP = _NoopTracer()


def as_tracer(trace) -> "Tracer | _NoopTracer":
    """Normalize an ``api``-level ``trace=`` argument.

    ``None``/``False`` -> ``NOOP``; ``True`` -> a fresh ``Tracer()``;
    an existing tracer object passes through (anything with ``enabled``
    and ``add_span`` duck-types).
    """
    if trace is None or trace is False:
        return NOOP
    if trace is True:
        return Tracer()
    return trace
