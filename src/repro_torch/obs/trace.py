"""Thread-safe tracing core of the port (its own copy of
``repro.obs.trace``, with the same span names and semantics, extended
with parent links, device time from CUDA events and one clock with
``torch.profiler``).

One ``Tracer`` owns one monotonic clock domain (``time.perf_counter``
anchored at construction), so spans recorded from the executor driver
thread, the serve loop, and the ``train_while_serve`` background
thread all land on a single comparable timeline. Producers record:

* ``span(name, device=None, parent=None, **attrs)`` — a context manager
  for a timed region, or ``start``/``stop`` when the region opens and
  closes in different calls (the chunked attention's backward, bounded
  by two autograd hooks), or the manual ``add_span(name, t0, t1=None,
  **attrs)`` (the executor opens a task span before an asynchronous
  CUDA launch and closes it after ``torch.cuda.synchronize()``).
* ``event(name, **attrs)`` — an instantaneous marker (prefetch hit,
  retry, shed, version-vector violation, ...).
* ``counter(name, value)`` — an accumulating scalar (checkpoint /
  restore / recovery seconds, the chunked attention's pairs).

Every span has an ``id`` and a ``parent``: the innermost span open on
the recording thread when it started, or the ``parent=`` given (a span
opened from an autograd hook names the span its forward's thread has
open, ``current(thread)``). ``analyze.self_s`` subtracts children.

``span(..., device=d)`` on a CUDA device also records a
``torch.cuda.Event`` pair on ``d``'s current stream at entry and exit;
nothing on the recording path synchronizes or reads an event.
``resolve()`` (which ``to_dict()`` calls) turns each pair into the
span's ``device_s`` once the caller has synchronized; on the CPU
``device_s`` is ``None``.

While ``torch.profiler`` runs, each span also enters
``torch.profiler.record_function(name)``, so the program's layers
appear in the profiler's timeline. ``meta["clock_anchor"]`` holds
``time.time_ns()`` and ``time.perf_counter_ns()`` read back to back at
construction; the tracer's t = 0 is that ``perf_ns``, so a span's
wall-clock time is ``wall_ns / 1e3 + t * 1e6`` microseconds
(``wall_us``), the base on which the profiler's ``ts +
baseTimeNanoseconds / 1e3`` lies.

Hot paths call ``active()`` once per call and use what it returns: the
tracer installed by ``use(tracer)``; else, while a ``torch.profiler``
session runs, the process's profiler-bound tracer, which
``take_profiled()`` drains (so a profiled run carries its program
spans without any caller installing a tracer). It holds one session at
most: once a hot path has seen the profiler stopped, the next profiled
span starts a fresh one and the old session's spans and CUDA events
are dropped. A caller that profiles the program and wants its spans
calls ``take_profiled()`` after the session; one that does not leaves
the last session's tracer in memory until the next. Else the module-level
``NOOP`` singleton, whose methods are constant-time attribute hits that
record nothing, create no CUDA event and enter no ``record_function``.
Producers that would do real work just to *build* a span (formatting
attrs, snapshotting queue depths, registering hooks) guard on
``tracer.enabled`` first.

``block_tasks`` is the asynchronous-launch knob of the executor's task
spans: with it (the default) a producer calls
``torch.cuda.synchronize()`` before closing each task span, so span
durations are real device time, at the cost of serializing per-task
overlap (an observer effect). With ``block_tasks=False`` spans measure
the launch only.

This module imports nothing from the rest of the package, so every
``core``/``serve`` module can depend on it without import cycles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class Span:
    """A closed timed region on the tracer's clock (seconds since t0);
    ``device_s``: its CUDA-event time, once resolved."""
    name: str
    t0: float
    t1: float
    thread: str
    attrs: Dict[str, Any]
    id: int = 0
    parent: Optional[int] = None
    device_s: Optional[float] = None

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


@dataclasses.dataclass
class OpenSpan:
    """A span between ``start`` and ``stop``."""
    name: str
    id: int
    parent: Optional[int]
    t0: float
    attrs: Dict[str, Any]
    ident: Optional[int]        # the thread whose stack holds it, if any
    event: Any = None           # the CUDA start event
    stream: Any = None
    mirror: Any = None          # the open record_function


def profiling() -> bool:
    """True while a ``torch.profiler`` session records."""
    return torch.autograd._profiler_enabled()


def _cuda(device) -> bool:
    return (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available())


class Tracer:
    """Collects spans/events/counters on one shared monotonic clock.

    Thread-safe: ``start``/``stop``/``add_span``/``event``/``counter``
    may be called concurrently from any thread; each record carries the
    recording thread's name (the Chrome exporter maps it to ``tid``).
    """

    enabled = True

    def __init__(self, *, block_tasks: bool = True,
                 meta: Optional[Dict[str, Any]] = None):
        self.block_tasks = block_tasks
        self.meta: Dict[str, Any] = dict(meta or {})
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.counters: Dict[str, float] = {}
        self._ids = itertools.count(1)
        self._stacks: Dict[int, List[int]] = {}
        self._pending: Dict[int, tuple] = {}    # span id -> (span, e0, e1)
        self._lock = threading.Lock()
        perf_ns = time.perf_counter_ns()
        wall_ns = time.time_ns()
        self._t0 = perf_ns * 1e-9
        self.meta["clock_anchor"] = {"wall_ns": wall_ns, "perf_ns": perf_ns}

    # -- clock ------------------------------------------------------------
    def now(self) -> float:
        """Seconds since this tracer was created (monotonic)."""
        return time.perf_counter() - self._t0

    # -- recording --------------------------------------------------------
    def current(self, ident: Optional[int] = None) -> Optional[int]:
        """The id of the innermost span open on thread ``ident``
        (default: the caller's), or None."""
        with self._lock:
            stack = self._stacks.get(threading.get_ident()
                                     if ident is None else ident)
            return stack[-1] if stack else None

    def start(self, name: str, *, device=None, parent: Optional[int] = None,
              push: bool = True, **attrs) -> OpenSpan:
        """Opens a span. ``push``: the span becomes the parent of the
        spans this thread starts until it stops (False for a span that
        another call closes, as a hook does). ``parent`` defaults to
        the thread's innermost open span."""
        ident = threading.get_ident()
        with self._lock:
            stack = self._stacks.get(ident)
            h = OpenSpan(name, next(self._ids),
                         stack[-1] if parent is None and stack else parent,
                         0.0, attrs, ident if push else None)
            if push:
                self._stacks.setdefault(ident, []).append(h.id)
        if _cuda(device):
            h.stream = torch.cuda.current_stream(device)
            h.event = torch.cuda.Event(enable_timing=True)
            h.event.record(h.stream)
        if profiling():
            h.mirror = torch.profiler.record_function(name)
            h.mirror.__enter__()
        h.t0 = self.now()
        return h

    def stop(self, h: OpenSpan) -> Span:
        """Closes ``h`` (from any thread) and records it."""
        t1 = self.now()
        if h.mirror is not None:
            h.mirror.__exit__(None, None, None)
        sp = Span(h.name, h.t0, t1, threading.current_thread().name,
                  h.attrs, h.id, h.parent)
        with self._lock:
            if h.ident is not None:
                stack = self._stacks[h.ident]
                stack.remove(h.id)
                if not stack:
                    del self._stacks[h.ident]
            self.spans.append(sp)
            if h.event is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(h.stream)
                self._pending[h.id] = (sp, h.event, end)
        return sp

    def add_span(self, name: str, t0: float, t1: Optional[float] = None,
                 **attrs) -> Span:
        """Record a region [t0, t1] (both in ``now()`` time; t1 defaults
        to the current instant); its parent is the thread's innermost
        open span."""
        if t1 is None:
            t1 = self.now()
        parent = self.current()
        sp = Span(name, t0, t1, threading.current_thread().name, attrs,
                  next(self._ids), parent)
        with self._lock:
            self.spans.append(sp)
        return sp

    @contextlib.contextmanager
    def span(self, name: str, *, device=None, parent: Optional[int] = None,
             **attrs):
        h = self.start(name, device=device, parent=parent, **attrs)
        try:
            yield self
        finally:
            self.stop(h)

    def event(self, name: str, **attrs) -> Event:
        ev = Event(name, self.now(), threading.current_thread().name, attrs)
        with self._lock:
            self.events.append(ev)
        return ev

    def counter(self, name: str, value: float = 1.0) -> None:
        """Accumulate ``value`` onto the named counter. A 0-d tensor
        (a count on the card) adds up where it lives and is read once,
        by ``to_dict``."""
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

    def resolve(self) -> None:
        """Sets ``device_s`` of every closed span with a CUDA event pair.
        Call after the work is done (a synchronize): each end event is
        waited for, so an unfinished one blocks."""
        with self._lock:
            pending, self._pending = self._pending, {}
        for sp, e0, e1 in pending.values():
            e1.synchronize()
            sp.device_s = e0.elapsed_time(e1) * 1e-3

    def to_dict(self) -> Dict[str, Any]:
        """Plain-data form consumed by the exporters and the analyzer
        (device times resolved first)."""
        self.resolve()
        with self._lock:
            return {
                "meta": dict(self.meta),
                "spans": [dataclasses.asdict(s) for s in self.spans],
                "events": [dataclasses.asdict(e) for e in self.events],
                "counters": {k: float(v) for k, v in self.counters.items()},
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

    def current(self, ident=None):
        return None

    def start(self, name, *, device=None, parent=None, push=True, **attrs):
        return None

    def stop(self, h):
        return None

    def add_span(self, name, t0, t1=None, **attrs):
        return None

    def span(self, name, *, device=None, parent=None, **attrs):
        return self._null_cm

    def event(self, name, **attrs):
        return None

    def counter(self, name, value=1.0):
        return None

    def span_count(self) -> int:
        return 0

    def snapshot(self, *, start: int = 0):
        return []

    def resolve(self):
        return None

    def to_dict(self):
        return {"meta": {}, "spans": [], "events": [], "counters": {}}


NOOP = _NoopTracer()

_installed: "Tracer | _NoopTracer | None" = None
_profiled: Optional[Tracer] = None
_profiled_ended = False     # a hot path has seen its session stopped
_profiled_lock = threading.Lock()


def active() -> "Tracer | _NoopTracer":
    """The tracer hot paths record into: the one ``use`` installed, else
    the profiler-bound tracer while ``torch.profiler`` runs, else
    ``NOOP``."""
    global _profiled_ended
    t = _installed
    if t is not None:
        return t
    if profiling():
        return _profiler_bound()
    if _profiled is not None:
        _profiled_ended = True
    return NOOP


def _profiler_bound() -> Tracer:
    """The profiler-bound tracer; a new one (the old dropped) once the
    old one's session has been seen to end."""
    global _profiled, _profiled_ended
    with _profiled_lock:
        if _profiled is None or _profiled_ended:
            _profiled = Tracer(block_tasks=False,
                               meta={"source": "torch.profiler"})
            _profiled_ended = False
        return _profiled


def take_profiled() -> Optional[Dict[str, Any]]:
    """The dict form of what the program recorded under
    ``torch.profiler`` with no tracer installed (device times resolved:
    call after a synchronize), or None; the next profiled span starts a
    new tracer."""
    global _profiled, _profiled_ended
    with _profiled_lock:
        t, _profiled, _profiled_ended = _profiled, None, False
    return None if t is None else t.to_dict()


@contextlib.contextmanager
def use(tracer):
    """Installs ``tracer`` as ``active()`` (process-wide, every thread)
    for the block, then restores the previous one."""
    global _installed
    prev = _installed
    _installed = tracer
    try:
        yield tracer
    finally:
        _installed = prev


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


def wall_us(trace: Dict[str, Any], t: float, base_ns: int = 0
            ) -> Optional[float]:
    """Wall-clock microseconds (the profiler's ``ts +
    baseTimeNanoseconds / 1e3``) of tracer time ``t`` of a trace dict,
    through its clock anchor, less ``base_ns`` / 1e3 (a profiler trace's
    ``baseTimeNanoseconds`` gives its ``ts``); None without an anchor."""
    a = trace.get("meta", {}).get("clock_anchor")
    return None if a is None else (a["wall_ns"] - base_ns) * 1e-3 + t * 1e6
