"""Serving replica: versioned snapshot install + fixed-shape scoring (the
port's copy of ``repro.serve.replica``).

The replica is the consumer end of the ``WeightBus``. Between request
batches it installs the next fully-assembled snapshot, stepping through
versions IN ORDER, and audits each install against the consistency
contract: the snapshot's version vector must be uniform (every layer at
the same chapter) and strictly newer than the installed one (monotone).
Any breach increments ``consistency_violations`` instead of installing.

Scoring pads every batch to one fixed ``max_batch`` shape, as the
reference does, so the kernel sees one shape per layer
(``max_batch * num_classes`` rows under the goodness classifier). It
runs eagerly on the installed parameters' device, through
``ff_mlp.class_scores`` and the fused ``ops.ff_dense``.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.convert import tree_leaves
from repro_torch.core import ff_mlp
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.bus import WeightBus


class Replica:
    def __init__(self, num_classes: int, *, max_batch: int,
                 eval_mode: str = "goodness", impl: str = "auto",
                 tracer=obs_trace.NOOP):
        self.num_classes = int(num_classes)
        self.max_batch = int(max_batch)
        self.eval_mode = eval_mode
        self.impl = impl
        self.tracer = tracer
        self.params: Optional[dict] = None
        self.version: int = -(2 ** 31)        # below any published version
        self.swaps: List[dict] = []           # install log (the timeline)
        self.consistency_violations = 0
        self.batches_scored = 0

    @property
    def ready(self) -> bool:
        return self.params is not None

    # ---- snapshot install ------------------------------------------------
    def _vector_ok(self, version: int, vec: list) -> bool:
        """The consistency contract: uniform (no half-published layer
        set) and monotone (never roll a replica backward)."""
        return (len(set(vec)) == 1 and vec[0] == version
                and version > self.version)

    def install(self, version: int, params: dict, vec: list,
                published_at: float, *, now: float = 0.0) -> bool:
        """Audit + install one snapshot; False (and a counted violation)
        if it breaches the version-vector contract."""
        t0 = self.tracer.now()
        if not self._vector_ok(version, vec):
            self.consistency_violations += 1
            if self.tracer.enabled:
                self.tracer.event("serve:violation", version=version,
                                  vec=list(vec), installed=self.version)
            return False
        self.params = params
        old = self.version
        self.version = version
        staleness = max(time.perf_counter() - published_at, 0.0)
        self.swaps.append({
            "t": now, "version": version, "from_version": old,
            "staleness_s": staleness})
        if self.tracer.enabled:
            self.tracer.add_span("serve:swap_install", t0, version=version,
                                 from_version=old, staleness_s=staleness)
        return True

    def maybe_swap(self, bus: WeightBus, *, now: float = 0.0) -> bool:
        """Install the next newer snapshot, if one is assembled. On the
        card the current stream (the serving loop's) first waits for the
        snapshot's clones (``bus.fences``) and is recorded on them, so
        the allocator keeps their blocks until its reads are done."""
        rec = bus.next_snapshot(self.version)
        if rec is None:
            return False
        events = bus.fences(rec[0])
        if events:
            stream = torch.cuda.current_stream(
                rec[1]["layers"][0]["w"].device)
            for ev in events:
                stream.wait_event(ev)
            for t in tree_leaves(rec[1]):
                t.record_stream(stream)
        return self.install(rec[0], rec[1], rec[2], rec[3], now=now)

    def drain(self, bus: WeightBus, *, now: float = 0.0) -> int:
        """Install every remaining version in order."""
        n = 0
        while self.maybe_swap(bus, now=now):
            n += 1
        return n

    # ---- scoring ---------------------------------------------------------
    def score(self, x: np.ndarray) -> np.ndarray:
        """(n, num_classes) scores for up to ``max_batch`` host rows; the
        batch is zero-padded to the fixed shape and the padding sliced
        back off."""
        if self.params is None:
            raise RuntimeError("replica has no installed snapshot yet")
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch of {n} exceeds max_batch="
                             f"{self.max_batch}")
        if n < self.max_batch:
            pad = np.zeros((self.max_batch - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        dev = self.params["layers"][0]["w"].device
        with torch.inference_mode():
            scores = ff_mlp.class_scores(
                self.params, torch.as_tensor(x, device=dev),
                self.num_classes, self.eval_mode, impl=self.impl)
            out = scores[:n].cpu().numpy()
        self.batches_scored += 1
        return out

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.score(x), axis=1).astype(np.int32)
