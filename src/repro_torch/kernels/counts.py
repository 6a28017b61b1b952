"""Kernel call counters that stay exact when several threads launch.

Each kernel module keeps one ``LAUNCHES = Counter()``: its calls that
launched the CUDA kernel, in this process, by the launching thread's
name. ``LAUNCHES += 1`` on a module global is a read, an add and a
write, and train-while-serve launches the MLP kernels from the training
thread and the serving thread at once; ``bump`` does the update under a
lock, so no call is lost between threads. The total is the sum of the
per-thread counts, so the two cannot drift apart.
"""
from __future__ import annotations

import threading


class Counter:
    """Launched calls of one kernel, by thread name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread = {}

    def bump(self):
        """Count one launched call on this thread."""
        name = threading.current_thread().name
        with self._lock:
            self._by_thread[name] = self._by_thread.get(name, 0) + 1

    def reset(self):
        with self._lock:
            self._by_thread.clear()

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._by_thread.values())

    @property
    def by_thread(self) -> dict:
        """A copy of thread name -> calls."""
        with self._lock:
            return dict(self._by_thread)


def reset(*modules):
    """Zero the counters of the kernel ``modules``."""
    for m in modules:
        m.LAUNCHES.reset()
