"""Bounded admission queue: accept or shed, never block.

The serving loop is open-loop — arrivals keep coming whether or not the
replica keeps up — so backpressure has to be explicit: a full queue
SHEDS the request (counted, surfaced in the ``.slo`` block) instead of
blocking the generator or growing without bound. The lock is shared
with nothing else; the serve loop and any admission thread touch the
queue only through ``offer``/``take``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One scoring request and its lifecycle record.

    ``t_arrival`` is on the stream's arrival clock (seconds since serve
    start); the engine fills the wall-clock fields as the request moves
    through the loop. ``version`` is the snapshot version that scored
    it — the per-request provenance the accuracy-vs-time curve and the
    consistency audit are built from.
    """
    id: int
    x: np.ndarray
    label: int
    t_arrival: float
    t_admit: Optional[float] = None      # wall seconds since serve start
    t_done: Optional[float] = None
    version: Optional[int] = None
    pred: Optional[int] = None

    @property
    def latency(self) -> Optional[float]:
        """Queueing + batching + scoring, from ARRIVAL (open-loop: time
        spent waiting behind a burst counts, like it would for a user)."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_arrival


class AdmissionQueue:
    """Bounded FIFO with shed-on-full admission control."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.stats = {"accepted": 0, "rejected": 0, "depth_peak": 0}

    def offer(self, req: Request) -> bool:
        """Admit ``req`` if there is room; False = shed (backpressure)."""
        with self._lock:
            if len(self._q) >= self.capacity:
                self.stats["rejected"] += 1
                return False
            self._q.append(req)
            self.stats["accepted"] += 1
            self.stats["depth_peak"] = max(self.stats["depth_peak"],
                                           len(self._q))
            return True

    def take(self, n: int) -> List[Request]:
        """Pop up to ``n`` requests in FIFO order (possibly empty)."""
        with self._lock:
            out = []
            while self._q and len(out) < n:
                out.append(self._q.popleft())
            return out

    def __len__(self):
        with self._lock:
            return len(self._q)

    def oldest_arrival(self) -> Optional[float]:
        """Arrival clock of the head request (None when empty) — what
        the batcher's max-wait knob is measured against."""
        with self._lock:
            return self._q[0].t_arrival if self._q else None
