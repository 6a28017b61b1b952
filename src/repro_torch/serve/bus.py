"""WeightBus: the publication channel from training to serving (the
port's copy of ``repro.serve.bus``).

Producers push per-layer pieces; serving replicas pull whole snapshots
out the other side. Consistency contract: a snapshot is exposed only
when EVERY layer (and the softmax head, when the classifier trains one)
has been published at the same version, so a request can never be
scored by a half-published layer set. Each exposed snapshot carries its
per-layer version vector; the replica re-checks it (uniform + monotone)
at install, and that check is the consistency-violation counter.

Copy on publish: a producer may update its tensors in place after
publishing, so every published leaf is cloned (``tensor.clone()``, the
counterpart of the reference's ``jnp.copy``): the bus owns its bits.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.convert import tree_map


def _owned(tree):
    """A copy that the producer's later in-place updates cannot reach."""
    return tree_map(lambda t: t.clone(), tree)


class WeightBus:
    """Assembles per-layer publications into versioned snapshots.

    ``publish_layer(k, version, piece)`` takes a per-layer dict
    (``{"layers": [lp]}``, plus ``"local_heads"`` for the §4.4 path);
    ``publish_head`` takes the softmax head's params. When version ``v``
    is complete the full params dict (the structure
    ``ff_mlp.class_scores`` consumes) is parked on the ready list;
    ``next_snapshot(after)`` hands snapshots out IN ORDER, one at a time.
    """

    def __init__(self, n_layers: int, *, has_head: bool = False):
        self.n_layers = int(n_layers)
        self.has_head = bool(has_head)
        self._lock = threading.Lock()
        self._staged: Dict[int, dict] = {}   # version -> {layer: piece} (+head)
        self._ready: List[tuple] = []        # (version, params, vec, wall_t)
        self.stats = {"layers_published": 0, "heads_published": 0,
                      "snapshots_assembled": 0, "snapshots_taken": 0}

    # ---- producer side ---------------------------------------------------
    def publish_layer(self, layer: int, version: int, piece: dict):
        piece = _owned(piece)
        with self._lock:
            self._staged.setdefault(version, {})[layer] = piece
            self.stats["layers_published"] += 1
            self._try_assemble(version)

    def publish_head(self, version: int, head_params):
        head_params = _owned(head_params)
        with self._lock:
            self._staged.setdefault(version, {})["head"] = head_params
            self.stats["heads_published"] += 1
            self._try_assemble(version)

    def publish_all(self, version: int, params: dict):
        """Publish a complete params dict in one call (a static
        serve-only model)."""
        params = _owned(params)
        with self._lock:
            staged = {k: {"layers": [lp]} for k, lp in
                      enumerate(params["layers"])}
            if "local_heads" in params:
                for k, lh in enumerate(params["local_heads"]):
                    staged[k]["local_heads"] = [lh]
            if self.has_head:
                staged["head"] = params["head"]
            self._staged[version] = staged
            self.stats["layers_published"] += self.n_layers
            if self.has_head:
                self.stats["heads_published"] += 1
            self._try_assemble(version)

    def _try_assemble(self, version: int):
        """Lock held. Park a full snapshot iff every piece is in."""
        staged = self._staged.get(version)
        if staged is None:
            return
        if any(k not in staged for k in range(self.n_layers)):
            return
        if self.has_head and "head" not in staged:
            return
        pieces = [staged[k] for k in range(self.n_layers)]
        params = {"layers": [p["layers"][0] for p in pieces]}
        if all("local_heads" in p for p in pieces):
            params["local_heads"] = [p["local_heads"][0] for p in pieces]
        vec = [version] * self.n_layers
        if self.has_head:
            params["head"] = staged["head"]
            vec = vec + [version]
        del self._staged[version]
        self._ready.append((version, params, vec, time.perf_counter()))
        self._ready.sort(key=lambda r: r[0])
        self.stats["snapshots_assembled"] += 1

    # ---- consumer side ---------------------------------------------------
    def next_snapshot(self, after_version: int
                      ) -> Optional[Tuple[int, dict, list, float]]:
        """The OLDEST fully-assembled snapshot newer than
        ``after_version`` as ``(version, params, version_vector,
        published_at)``, or None. Snapshots stay parked (several
        replicas may install the same version)."""
        with self._lock:
            for rec in self._ready:
                if rec[0] > after_version:
                    self.stats["snapshots_taken"] += 1
                    return rec
        return None

    def latest_version(self) -> Optional[int]:
        with self._lock:
            return self._ready[-1][0] if self._ready else None
