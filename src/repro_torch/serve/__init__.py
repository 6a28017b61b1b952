"""Serving subsystem of the port (``repro.serve``'s counterpart).

- ``traffic``  — deterministic open-loop request generators behind a
  registry (uniform / zipf / bursty).
- ``queue``    — bounded admission queue (accept or shed, never block).
- ``batcher``  — continuous batch former (max-batch / max-wait knobs).
- ``bus``      — ``WeightBus``: assembles per-layer publications into
  fully-consistent versioned snapshots.
- ``replica``  — scoring replica: installs snapshots monotonically with
  a version-vector check, scores fixed-shape batches through the fused
  ``ops.ff_dense`` path.
- ``engine``   — the serve loop, and ``train_while_serve``: the
  executor trains on a thread of its own and hot-publishes each layer
  into the bus the loop serves from. ``repro_torch.api.serve()`` is the
  supported entry point.
"""
from repro_torch.serve.batcher import Batcher                       # noqa: F401
from repro_torch.serve.bus import WeightBus                         # noqa: F401
from repro_torch.serve.engine import (                              # noqa: F401
    ServeConfig, run_serve, train_while_serve)
from repro_torch.serve.queue import AdmissionQueue, Request         # noqa: F401
from repro_torch.serve.replica import Replica                       # noqa: F401
from repro_torch.serve.traffic import (                             # noqa: F401
    RequestStream, TrafficStrategy, register_traffic, traffic)
