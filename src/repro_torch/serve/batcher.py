"""Continuous batch former: the max-batch / max-wait trade-off knob.

A batch is released when it is FULL (``max_batch`` requests ready — the
throughput case) or when the head request has waited ``max_wait_s``
since arrival (the latency case: a lone request is not held hostage to
fill a batch). Everything in between is the continuous-batching
spectrum the serve benchmark sweeps.
"""
from __future__ import annotations

from typing import List

from repro_torch.serve.queue import AdmissionQueue, Request


class Batcher:
    def __init__(self, max_batch: int, max_wait_s: float):
        if max_batch <= 0:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.batches_formed = 0

    def form(self, queue: AdmissionQueue, now: float,
             *, flush: bool = False) -> List[Request]:
        """Release the next batch, or [] if the release condition is not
        met yet. ``now`` is on the same clock as request arrivals.
        ``flush=True`` releases whatever is queued regardless of the
        knobs (drain at shutdown)."""
        depth = len(queue)
        if depth == 0:
            return []
        if not flush and depth < self.max_batch:
            oldest = queue.oldest_arrival()
            if oldest is None or now - oldest < self.max_wait_s:
                return []
        batch = queue.take(self.max_batch)
        if batch:
            self.batches_formed += 1
        return batch
