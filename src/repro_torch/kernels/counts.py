"""Kernel call counters that stay exact when several threads launch.

Each kernel module keeps one ``LAUNCHES = Counter()``: its calls that
launched the CUDA kernel, in this process, by the launching thread's
name. ``LAUNCHES += 1`` on a module global is a read, an add and a
write, and train-while-serve launches the MLP kernels from the training
thread and the serving thread at once; ``bump`` does the update under a
lock, so no call is lost between threads. The total is the sum of the
per-thread counts, so the two cannot drift apart. A counter may be
keyed by something else than the thread: ``ff_dense.TILE_LAUNCHES``
counts calls by the ``(bn, S)`` tile they launched (``bump(key)``).
"""
from __future__ import annotations

import threading


class Counter:
    """Launched calls of one kernel, by thread name (or by the caller's
    key)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread = {}

    def bump(self, key=None):
        """Count one launched call under ``key``, by default this
        thread's name."""
        if key is None:
            key = threading.current_thread().name
        with self._lock:
            self._by_thread[key] = self._by_thread.get(key, 0) + 1

    def reset(self):
        with self._lock:
            self._by_thread.clear()

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._by_thread.values())

    @property
    def by_thread(self) -> dict:
        """A copy of thread name (or key) -> calls."""
        with self._lock:
            return dict(self._by_thread)


def reset(*modules):
    """Zero the counters of the kernel ``modules``: ``LAUNCHES``, and
    ``BWD_LAUNCHES`` where a module has a backward kernel of its own."""
    for m in modules:
        m.LAUNCHES.reset()
        if hasattr(m, "BWD_LAUNCHES"):
            m.BWD_LAUNCHES.reset()
