"""The serve loop (the port's copy of ``repro.serve.engine``'s serve-only
part).

``run_serve`` is one wall-clock continuous-batching loop: replay the
stream's open-loop arrivals against real time, admit into the bounded
queue (shedding on overload), form batches under the max-batch /
max-wait knobs, hot-swap the replica between batches, and score through
the fused kernel path. ``serve_static`` drives it from one fixed params
snapshot. The reference's ``train_while_serve`` (the executor training
underneath, publishing into the same bus) comes with the executor
slice, and with it the loop's drain-at-end-of-training branch.

Observability: every entry point takes ``tracer=`` (an ``obs.trace``
tracer, default the no-op singleton). The loop records admission /
batch-form / score spans and shed events; the replica records
swap-install spans and violation events on the same tracer.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch import data as data_lib
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.batcher import Batcher
from repro_torch.serve.bus import WeightBus
from repro_torch.serve.queue import AdmissionQueue, Request
from repro_torch.serve.replica import Replica
from repro_torch.serve.traffic import RequestStream, traffic as traffic_registry

_IDLE_SLEEP_S = 0.0005


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of one serving run (``api.serve``).

    ``rate`` is the nominal open-loop arrival rate (requests/second);
    ``n_requests`` bounds a serve-only run. (The reference's
    ``final_probe`` belongs to train-while-serve and comes with it.)
    """
    traffic: str = "uniform"
    rate: float = 300.0
    n_requests: Optional[int] = None
    max_batch: int = 64
    max_wait_s: float = 0.02
    queue_cap: int = 512
    seed: int = 0

    def __post_init__(self):
        if self.traffic not in traffic_registry:
            raise ValueError(
                f"unknown traffic strategy {self.traffic!r}; registered: "
                f"{', '.join(traffic_registry.names())}")


@dataclasses.dataclass
class EngineResult:
    """Raw output of one serve loop (``api.ServeResult`` wraps it)."""
    requests: List[Request]          # completed, in scoring order
    swaps: List[dict]                # replica install timeline
    consistency_violations: int
    queue_stats: dict
    bus_stats: dict
    timings: dict                    # serve_s
    batches_scored: int


def _score_batch(replica: Replica, batch: List[Request], now):
    x = np.stack([r.x for r in batch])
    preds = replica.predict(x)
    t_done = now()
    for r, p in zip(batch, preds):
        r.pred = int(p)
        r.version = replica.version
        r.t_done = t_done


def run_serve(replica: Replica, bus: WeightBus, stream: RequestStream,
              sconfig: ServeConfig, *,
              tracer=obs_trace.NOOP) -> EngineResult:
    """The continuous-batching loop; stops once ``n_requests`` arrivals
    were admitted or shed and the queue is drained."""
    n_target = sconfig.n_requests
    if n_target is None:
        raise ValueError("serve-only mode needs ServeConfig.n_requests")
    if tracer.enabled:
        replica.tracer = tracer
    t_loop0 = tracer.now()
    queue = AdmissionQueue(sconfig.queue_cap)
    batcher = Batcher(sconfig.max_batch, sconfig.max_wait_s)
    done: List[Request] = []
    t0 = time.perf_counter()
    now = lambda: time.perf_counter() - t0
    upcoming = []                    # reversed [(t_arrival, Request)]
    admitted = 0

    def refill():
        nonlocal upcoming
        if not upcoming:
            want = min(64, n_target - admitted)
            if want > 0:
                upcoming = stream.take(want)[::-1]

    while True:
        t = now()
        # 1) admit everything that has "arrived" by the wall clock
        refill()
        t_admit0 = tracer.now()
        n_before = admitted
        while upcoming and upcoming[-1][0] <= t and admitted < n_target:
            _, req = upcoming.pop()
            req.t_admit = t
            if not queue.offer(req) and tracer.enabled:
                tracer.event("serve:shed", id=req.id,
                             depth=len(queue))
            admitted += 1
            refill()
        if tracer.enabled and admitted > n_before:
            tracer.add_span("serve:admit", t_admit0,
                            n=admitted - n_before)
        # 2) hot-swap between batches: a batch in flight is never torn
        replica.maybe_swap(bus, now=t)
        # 3) form + score (only once a first snapshot is installed)
        no_more = admitted >= n_target
        t_form0 = tracer.now()
        batch = (batcher.form(queue, t, flush=no_more)
                 if replica.ready else [])
        if batch:
            if tracer.enabled:
                tracer.add_span("serve:batch_form", t_form0,
                                n=len(batch))
            t_score0 = tracer.now()
            _score_batch(replica, batch, now)
            if tracer.enabled:
                tracer.add_span("serve:score", t_score0, n=len(batch),
                                version=replica.version)
            done.extend(batch)
            continue
        # 4) termination: every generated request was admitted-or-shed
        #    and the queue is drained (a shed request completes by
        #    rejection; waiting for it to be scored would spin forever)
        if no_more and len(queue) == 0:
            break
        time.sleep(_IDLE_SLEEP_S)

    replica.drain(bus, now=now())
    if tracer.enabled:
        tracer.add_span("serve:loop", t_loop0, requests=len(done),
                        swaps=len(replica.swaps),
                        violations=replica.consistency_violations)
    return EngineResult(
        requests=done, swaps=list(replica.swaps),
        consistency_violations=replica.consistency_violations,
        queue_stats=dict(queue.stats), bus_stats=dict(bus.stats),
        timings={"serve_s": now()},
        batches_scored=replica.batches_scored)


def _make_stream(source, sconfig: ServeConfig, num_classes):
    strat = traffic_registry.get(sconfig.traffic)
    return RequestStream(source, strat, rate=sconfig.rate,
                         num_classes=num_classes, seed=sconfig.seed)


def serve_static(params, cfg, source: data_lib.Source,
                 sconfig: ServeConfig, *, eval_mode="goodness",
                 impl="auto", tracer=obs_trace.NOOP) -> EngineResult:
    """Serve-only: a fixed params snapshot (version 0), no training
    underneath — the deterministic-replay mode."""
    n_layers = len(params["layers"])
    bus = WeightBus(n_layers, has_head="head" in params)
    bus.publish_all(0, params)
    replica = Replica(cfg.num_classes, max_batch=sconfig.max_batch,
                      eval_mode=eval_mode, impl=impl, tracer=tracer)
    stream = _make_stream(source, sconfig, cfg.num_classes)
    return run_serve(replica, bus, stream, sconfig, tracer=tracer)


# ---------------------------------------------------------------------------
# SLO summary (the ``.slo`` stats block on api.ServeResult)
# ---------------------------------------------------------------------------

def summarize(res: EngineResult) -> dict:
    """p50/p99 latency, throughput, shed rate, swap/staleness stats and
    the consistency counter — one dict, JSON-ready."""
    lats = np.asarray([r.latency for r in res.requests
                       if r.latency is not None])
    stale = np.asarray([s["staleness_s"] for s in res.swaps])
    serve_s = max(res.timings.get("serve_s", 0.0), 1e-9)
    n = len(res.requests)
    acc_reqs = [r for r in res.requests if r.pred is not None]
    return {
        "requests": n,
        "throughput_rps": n / serve_s,
        "latency_p50_ms": float(np.percentile(lats, 50)) * 1e3 if n else None,
        "latency_p99_ms": float(np.percentile(lats, 99)) * 1e3 if n else None,
        "latency_mean_ms": float(lats.mean()) * 1e3 if n else None,
        "accuracy": (float(np.mean([r.pred == r.label for r in acc_reqs]))
                     if acc_reqs else None),
        "accepted": res.queue_stats["accepted"],
        "rejected": res.queue_stats["rejected"],
        "shed_rate": (res.queue_stats["rejected"]
                      / max(res.queue_stats["accepted"]
                            + res.queue_stats["rejected"], 1)),
        "queue_depth_peak": res.queue_stats["depth_peak"],
        "swaps": len(res.swaps),
        "staleness_mean_s": float(stale.mean()) if len(stale) else None,
        "staleness_max_s": float(stale.max()) if len(stale) else None,
        "consistency_violations": res.consistency_violations,
    }


def accuracy_by_version(res: EngineResult) -> dict:
    """version -> (n_requests, accuracy): the accuracy-vs-time curve
    keyed by the snapshot that scored each window."""
    by_v = {}
    for r in res.requests:
        if r.pred is None:
            continue
        by_v.setdefault(r.version, []).append(r.pred == r.label)
    return {int(v): {"n": len(ok), "accuracy": float(np.mean(ok))}
            for v, ok in sorted(by_v.items())}
