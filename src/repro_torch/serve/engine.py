"""The serve loop and the combined train-while-serve driver (the port's
copy of ``repro.serve.engine``).

``run_serve`` is one wall-clock continuous-batching loop: replay the
stream's open-loop arrivals against real time, admit into the bounded
queue (shedding on overload), form batches under the max-batch /
max-wait knobs, hot-swap the replica between batches, and score through
the fused kernel path. ``serve_static`` drives it from one fixed params
snapshot. ``train_while_serve`` runs ``PFFExecutor.run(publish=bus)``
on a ``pff-train`` thread and serves from the same bus while training
is in flight: each freshly trained layer is hot-published into the
serving replica.

Streams: the loop scores on a CUDA stream of its own (``serve_stream``),
not on the default stream, so it never orders itself behind the
executor's node streams by accident; PyTorch's current stream is per
thread, so the training thread keeps its nodes' streams. A snapshot
crosses from the training streams to the serving stream through the
bus's events (``serve.bus``).

Observability: every entry point takes ``tracer=`` (an ``obs.trace``
tracer, default the no-op singleton). The loop records admission /
batch-form / score spans and shed events; the replica records
swap-install spans and violation events on the same tracer. In combined
mode ``train_while_serve`` hands that one tracer to the executor thread
too, so training task spans and serving spans share one clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

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
    """Knobs of one serving run (``api.serve`` / ``api.fit(serve=...)``).

    ``rate`` is the nominal open-loop arrival rate (requests/second);
    ``n_requests`` bounds a serve-only run (ignored while training runs
    underneath: there the loop serves until the trainer finishes);
    ``final_probe`` requests are served AFTER the last hot-swap so the
    accuracy-vs-time curve always has a window at the final weights.
    """
    traffic: str = "uniform"
    rate: float = 300.0
    n_requests: Optional[int] = None
    max_batch: int = 64
    max_wait_s: float = 0.02
    queue_cap: int = 512
    seed: int = 0
    final_probe: int = 128

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
    timings: dict                    # serve_s (+ train_s when combined)
    batches_scored: int
    exec_result: Optional[object] = None   # pff_exec.ExecResult
    train_error: Optional[BaseException] = None


def _score_batch(replica: Replica, batch: List[Request], now):
    x = np.stack([r.x for r in batch])
    preds = replica.predict(x)
    t_done = now()
    for r, p in zip(batch, preds):
        r.pred = int(p)
        r.version = replica.version
        r.t_done = t_done


def serve_stream(device):
    """A CUDA stream of the serving loop's own on ``device`` (None on
    the CPU)."""
    device = torch.device(device)
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def run_serve(replica: Replica, bus: WeightBus, stream: RequestStream,
              sconfig: ServeConfig, *, producer_done=None,
              cuda_stream=None, tracer=obs_trace.NOOP) -> EngineResult:
    """The continuous-batching loop.

    ``producer_done`` (a callable -> bool) marks the training thread's
    completion in combined mode: the loop then drains every remaining
    snapshot and serves ``final_probe`` more requests at the final
    weights before stopping. Without it the loop stops after
    ``n_requests`` completions (serve-only replay). ``cuda_stream``: the
    stream the loop scores on (``serve_stream``); None keeps the
    caller's current stream.
    """
    n_target = sconfig.n_requests if producer_done is None else None
    if producer_done is None and n_target is None:
        raise ValueError("serve-only mode needs ServeConfig.n_requests")
    if tracer.enabled:
        # swap-install spans / violation events land on the loop's
        # tracer (one clock domain with the executor in combined mode)
        replica.tracer = tracer
    with torch.cuda.stream(cuda_stream):        # None: a no-op
        return _loop(replica, bus, stream, sconfig, n_target,
                     producer_done, tracer)


def _loop(replica, bus, stream, sconfig, n_target, producer_done, tracer):
    t_loop0 = tracer.now()
    queue = AdmissionQueue(sconfig.queue_cap)
    batcher = Batcher(sconfig.max_batch, sconfig.max_wait_s)
    done: List[Request] = []
    t0 = time.perf_counter()
    now = lambda: time.perf_counter() - t0
    upcoming = []                    # reversed [(t_arrival, Request)]
    admitted = 0
    draining = False                 # training over: probe then stop
    probe_left = 0

    def refill():
        nonlocal upcoming
        if not upcoming:
            want = min(64, n_target - admitted) if n_target else 64
            if want > 0:
                upcoming = stream.take(want)[::-1]

    while True:
        t = now()
        # 1) admit everything that has "arrived" by the wall clock, or
        #    immediately during the final drain probe (those are
        #    re-stamped to arrive "now" so their latency is pure service
        #    time, not a fictional negative wait)
        refill()
        t_admit0 = tracer.now()
        n_before = admitted
        while upcoming and (draining or upcoming[-1][0] <= t):
            if n_target is not None and admitted >= n_target:
                break
            if draining:
                if probe_left <= 0:
                    break
                probe_left -= 1
            _, req = upcoming.pop()
            if draining:
                req.t_arrival = t
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
        # 3) form + score (only once a first snapshot is installed; until
        #    then arrivals just queue up, shedding on overflow)
        no_more = ((n_target is not None and admitted >= n_target)
                   or (draining and probe_left <= 0))
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
        # 4) termination: serve-only stops once every generated request
        #    was admitted-or-shed and the queue is drained (a shed request
        #    completes by rejection; waiting for it to be scored would
        #    spin forever)
        if (n_target is not None and admitted >= n_target
                and len(queue) == 0):
            break
        if producer_done is not None and not draining and producer_done():
            draining = True
            replica.drain(bus, now=now())
            probe_left = sconfig.final_probe
        elif draining and (len(queue) == 0 and probe_left <= 0
                           or not replica.ready):
            # probe served, or the trainer died before publishing
            # anything installable; either way nothing left to score
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
    return run_serve(replica, bus, stream, sconfig,
                     cuda_stream=serve_stream(
                         params["layers"][0]["w"].device),
                     tracer=tracer)


def train_while_serve(executor, sconfig: ServeConfig,
                      source: Optional[data_lib.Source] = None,
                      *, resume_from=None,
                      tracer=obs_trace.NOOP) -> EngineResult:
    """Run the executor with live publication and serve from the same
    bus concurrently. The training thread's result rides back on the
    ``EngineResult``; a training exception stops the serve loop (it
    drains and probes what was published) and is re-raised here, never
    swallowed.

    A traced combined run hands the ONE tracer to both drivers: the
    executor's task spans (recorded on the ``pff-train`` thread) and
    the serve loop's spans share a clock, so swap installs line up
    against the chapter-train tasks that published them. The default
    tracer blocks per task (``block_tasks=True``), which slows training
    and shifts the serve timeline; pass ``Tracer(block_tasks=False)`` to
    observe serving with training overlap intact."""
    bus = WeightBus(executor.n_layers, has_head=executor.has_head)
    replica = Replica(executor.cfg.num_classes,
                      max_batch=sconfig.max_batch,
                      eval_mode=executor.good.eval_mode(executor.cfg),
                      impl=executor.impl, tracer=tracer)
    if source is None:
        source = data_lib.source_of(executor.task)
    stream = _make_stream(source, sconfig, executor.cfg.num_classes)

    box = {}

    def trainer():
        t0 = time.perf_counter()
        try:
            box["result"] = executor.run(
                publish=bus, resume_from=resume_from,
                trace=tracer if tracer.enabled else None)
        except BaseException as e:              # surfaced to the caller
            box["error"] = e
        box["train_s"] = time.perf_counter() - t0

    th = threading.Thread(target=trainer, name="pff-train", daemon=True)
    th.start()
    out = run_serve(replica, bus, stream, sconfig,
                    producer_done=lambda: not th.is_alive(),
                    cuda_stream=serve_stream(executor.devices[0]),
                    tracer=tracer)
    th.join()
    out.exec_result = box.get("result")
    out.train_error = box.get("error")
    out.timings["train_s"] = box.get("train_s", 0.0)
    if out.train_error is not None:
        raise out.train_error
    return out


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
