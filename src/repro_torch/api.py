"""``repro_torch.api`` — the port's facade (``repro.api``'s counterpart).

Training (``fit``) drives the paper's chapter schedule on the card:

    from repro_torch import api, data
    from repro_torch.configs.ff_mlp import PAPER_MLP

    task = data.mnist_like(n_train=4096, n_test=1000)
    res = api.fit(PAPER_MLP, task)                          # sequential
    res = api.fit(PAPER_MLP, task, backend="federated", num_nodes=4)
    res = api.fit(PAPER_MLP, task, backend="executor",      # real nodes
                  schedule="all_layers", num_nodes=4)
    res = api.fit(PAPER_MLP, task, backend="simulate",      # event sim
                  schedule="all_layers", num_nodes=4)
    api.simulate(res, "single_layer", 4).speedup

The ``executor`` backend runs the schedule on ``num_nodes`` nodes, each a
CUDA stream of its own on the card (N x ``cuda:0``) or, with
``device="cpu"``, N x ``cpu`` in order, bit-exact against
``sequential`` (``federated`` for its schedule); ``resilience=`` adds
chapter checkpoints, fault injection, retries and dead-node recovery,
``resume_from=`` resumes from a chapter manifest.

Serving (``serve``) answers requests from a fixed parameter snapshot:

    res = api.serve(PAPER_MLP, task, params=res.params, traffic="uniform",
                    n_requests=1024, rate=2000.0, max_batch=64)
    res.slo["latency_p99_ms"], res.slo["consistency_violations"]

Both run on ``cuda`` unless ``device="cpu"`` is passed. Strategy
variation (negatives, goodness objective, classifier) is config-driven
through the registries re-exported here. The ``pod`` backend and
train-while-serve (``fit(serve=...)``, ``serve`` without ``params=``)
come with later slices; they raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch import data as data_lib
from repro_torch.convert import tree_map
from repro_torch.core import ff_mlp, pff, pff_exec, strategies
from repro_torch.core.faults import (        # noqa: F401  re-exported
    FaultPlan, ResilienceConfig,
)
from repro_torch.core.strategies import (    # noqa: F401  re-exported
    classifier, goodness, negatives,
    register_classifier, register_goodness, register_negatives,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import registry as kernel_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import engine as serve_engine
from repro_torch.serve.engine import ServeConfig       # noqa: F401  re-export
from repro_torch.serve.traffic import register_traffic, traffic  # noqa: F401

__all__ = ["fit", "simulate", "serve", "FitResult", "ServeResult",
           "ServeConfig", "BACKENDS",
           "negatives", "goodness", "classifier", "traffic",
           "register_negatives", "register_goodness",
           "register_classifier", "register_traffic",
           "FaultPlan", "ResilienceConfig"]

BACKENDS = ("sequential", "simulate", "executor", "federated", "pod")

# the slice of the port each backend not ported yet comes with
_PENDING_BACKENDS = {
    "pod": "the pod slice (core/pff_pod.py on torch.distributed)",
}


@dataclasses.dataclass
class FitResult:
    """What every backend returns, as the reference's ``FitResult``
    has it for the ported backends. Fields a backend cannot measure stay
    None (``makespan`` for plain sequential training). ``raw`` keeps the
    backend's own result (``pff.TrainResult``, ``pff_exec.ExecResult``)."""
    backend: str
    cfg: object
    params: Optional[dict] = None
    schedule: Optional[str] = None
    num_nodes: int = 1
    records: Optional[List[pff.TaskRecord]] = None
    test_acc: Optional[float] = None
    train_acc: Optional[float] = None
    history: list = dataclasses.field(default_factory=list)
    makespan: Optional[float] = None
    speedup: Optional[float] = None
    utilization: Optional[float] = None
    sim: Optional[pff.SimResult] = None
    profile: Optional[dict] = None          # executor: {"node_busy"}
    resilience: Optional[dict] = None       # executor: retry/checkpoint stats
    device: Optional[str] = None
    trace: Optional[object] = None          # obs.trace.Tracer (trace=...)
    raw: object = None


@dataclasses.dataclass
class ServeResult:
    """What ``serve`` returns: per-request lifecycle ``records``, the
    hot-swap timeline, per-phase ``timings`` and the ``.slo`` block
    (p50/p99 latency, throughput, shed rate, swaps, staleness,
    consistency violations), as the reference's ``ServeResult`` has
    them for a serve-only run."""
    cfg: object
    traffic: str
    device: str
    records: Optional[List[dict]] = None
    swaps: Optional[List[dict]] = None
    slo: Optional[dict] = None
    timings: Optional[dict] = None          # {"serve_s"}
    accuracy_by_version: Optional[dict] = None
    test_acc: Optional[float] = None        # accuracy over served requests
    trace: Optional[object] = None          # obs.trace.Tracer (trace=...)
    raw: object = None                      # serve.engine.EngineResult


def _validate_strategies(cfg):
    """Fail fast with the registries' helpful errors + pairing checks
    (goodness, negatives, classifier and kernel impl)."""
    good = strategies.goodness.get(cfg.goodness_fn)
    strategies.negatives.get(cfg.neg_mode)
    cls = strategies.classifier.get(cfg.classifier)
    impl = ff_mlp.kernel_impl(cfg)
    if impl != "auto":
        kernel_registry.ff_dense.get(impl)
    if cls.requires_goodness and cfg.goodness_fn != cls.requires_goodness:
        raise ValueError(
            f"classifier {cfg.classifier!r} reads parameters trained by "
            f"goodness_fn={cls.requires_goodness!r}, but the config has "
            f"goodness_fn={cfg.goodness_fn!r}")
    return good


def fit(cfg, task=None, *, backend="sequential", schedule=None,
        num_nodes=1, probe_every=0, verbose=False, profile=False,
        devices=None, overlap=True, resilience=None, resume_from=None,
        serve=None, trace=None, comm_time=0.0, device=None,
        key=None) -> FitResult:
    """Train ``cfg`` on ``task`` with the chosen backend.

    sequential  the canonical chapter-schedule trainer (times every
                task; its records feed the simulator).
    federated   the same trainer on ``num_nodes`` node-local shards
                (Federated PFF §4.3).
    executor    ``core.pff_exec.PFFExecutor``: ``schedule`` (default
                ``"all_layers"``, or ``"sequential"`` when
                ``num_nodes == 1``) run on ``num_nodes`` nodes, each a
                CUDA stream of its own (``devices=`` names their devices;
                a repeated device is allowed), bit-exact against
                ``sequential`` (``federated`` for its schedule).
    simulate    trains sequentially once, then replays the measured task
                timings under ``schedule`` (default ``"all_layers"``, or
                ``"sequential"`` when ``num_nodes == 1``) on
                ``num_nodes`` simulated nodes; ``comm_time`` is the
                per-DAG-edge cross-node hand-off cost.

    probe_every/verbose: chapter-level accuracy probes.
    profile: executor: synchronize after every task and return per-task
    records and node busy times (run again without it for makespan).
    overlap: executor: the double-buffered hand-off (default); False
    pulls on demand (the weight stream is bit-identical either way).
    resilience: executor: a ``ResilienceConfig`` (chapter checkpoints,
    retry/backoff, dead-node recovery, fault injection, elastic
    federated membership); stats on ``FitResult.resilience``.
    resume_from: executor: a chapter manifest (or its directory) written
    by a previous resilient run; training replays from the next chapter.
    serve: train-while-serve, which comes with the next slice.
    trace: ``True`` or an ``obs.trace.Tracer``: one span around the
    backend's run, in ``FitResult.trace``.
    device: ``None`` = ``cuda`` (raises without a GPU); ``"cpu"`` runs
    the plain PyTorch path.
    key: the run's random key (``core.rng``); default
    ``TorchKey(cfg.seed)``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend in _PENDING_BACKENDS:
        raise NotImplementedError(
            f"backend={backend!r} is not ported yet: it comes with "
            f"{_PENDING_BACKENDS[backend]}")
    if (resilience is not None or resume_from is not None) \
            and backend != "executor":
        raise ValueError(
            f"resilience/resume_from are executor-backend features "
            f"(chapter checkpoints, fault injection, elastic "
            f"membership); got backend={backend!r}")
    if serve is not None:
        raise NotImplementedError(
            "fit(serve=...) is not ported yet: it comes with the "
            "train-while-serve slice (serve/engine.py's train_while_serve)")
    _validate_strategies(cfg)
    # an executor given its nodes' devices needs no default device
    dev = (None if backend == "executor" and devices is not None
           else resolve_device(device))
    tracer = obs_trace.as_tracer(trace)
    out_trace = tracer if tracer.enabled else None
    if backend == "executor":
        schedule = schedule or ("sequential" if num_nodes == 1
                                else "all_layers")
        ex = pff_exec.PFFExecutor(cfg, task, schedule, num_nodes,
                                  devices=devices, overlap=overlap,
                                  resilience=resilience, device=dev,
                                  key=key)
        res = ex.run(profile=profile, resume_from=resume_from,
                     trace=out_trace)
        return FitResult(
            backend=backend, cfg=cfg, params=res.params, schedule=schedule,
            num_nodes=num_nodes, records=res.records, test_acc=res.test_acc,
            makespan=res.makespan,
            profile=({"node_busy": res.node_busy}
                     if res.node_busy is not None else None),
            resilience=res.resilience, device=str(ex.devices[0]),
            trace=res.trace, raw=res)
    kw = dict(probe_every=probe_every, verbose=verbose, device=dev,
              key=key)
    sim = None
    if backend == "federated":
        schedule = "federated"
        with tracer.span("fit:federated", num_nodes=num_nodes):
            res = pff.run_federated_schedule(cfg, task, num_nodes, **kw)
    elif backend == "sequential":
        schedule, num_nodes = "sequential", 1
        with tracer.span("fit:sequential"):
            res = pff.run_chapter_schedule(cfg, task, **kw)
    else:       # simulate: train once, replay the task times
        schedule = schedule or ("sequential" if num_nodes == 1
                                else "all_layers")
        with tracer.span("fit:simulate", schedule=schedule,
                         num_nodes=num_nodes):
            res = pff.run_chapter_schedule(cfg, task, **kw)
            sim = pff.simulate_schedule(res.records, schedule, num_nodes,
                                        comm_time=comm_time)
    return FitResult(
        backend=backend, cfg=cfg, params=res.params, schedule=schedule,
        num_nodes=num_nodes, records=res.records, test_acc=res.test_acc,
        train_acc=res.train_acc, history=res.history,
        makespan=sim.makespan if sim else None,
        speedup=sim.speedup if sim else None,
        utilization=sim.utilization if sim else None, sim=sim,
        device=str(dev), trace=out_trace, raw=res)


def simulate(result_or_records, schedule, num_nodes,
             **kw) -> pff.SimResult:
    """Replay a training run's task records under another schedule:
    a ``FitResult`` or a raw record list."""
    records = getattr(result_or_records, "records", result_or_records)
    if records is None:
        raise ValueError("no task records on this result")
    return pff.simulate_schedule(records, schedule, num_nodes, **kw)


def _serve_records(engine_res) -> List[dict]:
    """Per-request lifecycle dicts (JSON-ready)."""
    return [{"id": r.id, "t_arrival": r.t_arrival, "t_admit": r.t_admit,
             "t_done": r.t_done, "latency": r.latency,
             "version": r.version, "pred": r.pred, "label": r.label,
             "correct": (r.pred == r.label) if r.pred is not None
             else None}
            for r in engine_res.requests]


def serve(cfg, task=None, *, traffic=None, source=None, params=None,
          serve_cfg=None, trace=None, device=None,
          **knobs) -> ServeResult:
    """Serve the config's classifier from a fixed ``params`` snapshot
    under deterministic open-loop traffic.

    traffic: a name from the ``traffic`` registry (uniform / zipf /
    bursty, or anything added with ``register_traffic``).
    source: a ``data.Source`` for request payloads; defaults to the
    task's test split (``data.source_of``).
    params: a params dict of tensors (``ff_mlp.init``'s layout, or a
    reference tree through ``convert.params_from_numpy``); it is moved
    to ``device``. ``n_requests`` bounds the run (default 256).
    serve_cfg / **knobs: a ``ServeConfig``, and/or its fields as
    keywords (``rate=...``, ``max_batch=...``, ``max_wait_s=...``,
    ``queue_cap=...``, ``n_requests=...``, ``seed=...``); keywords win.
    trace: ``True`` or an ``obs.trace.Tracer`` — record admission /
    batch-form / score / swap-install spans into ``ServeResult.trace``.
    device: ``None`` = ``cuda`` (raises without a GPU); ``"cpu"`` runs
    the plain PyTorch path.
    """
    base = serve_cfg if serve_cfg is not None else ServeConfig()
    if traffic is not None:
        knobs["traffic"] = traffic
    valid = {f.name for f in dataclasses.fields(ServeConfig)}
    bad = set(knobs) - valid
    if bad:
        raise TypeError(f"unknown ServeConfig knob(s) {sorted(bad)}; "
                        f"valid: {sorted(valid)}")
    sconfig = dataclasses.replace(base, **knobs)

    good = _validate_strategies(cfg)
    if params is None:
        raise NotImplementedError(
            "train-while-serve (the executor publishing into a serving "
            "replica) is not ported yet: it comes with the next slice; "
            "pass params= to serve a fixed snapshot")
    dev = resolve_device(device)
    tracer = obs_trace.as_tracer(trace)
    if source is None:
        if task is None:
            raise ValueError("serve needs a task or an explicit "
                             "source= for request payloads")
        source = data_lib.source_of(task)
    if sconfig.n_requests is None:
        sconfig = dataclasses.replace(sconfig, n_requests=256)

    engine_res = serve_engine.serve_static(
        tree_map(lambda t: t.to(dev), params), cfg, source, sconfig,
        eval_mode=good.eval_mode(cfg), impl=ff_mlp.kernel_impl(cfg),
        tracer=tracer)
    slo = serve_engine.summarize(engine_res)
    return ServeResult(
        cfg=cfg, traffic=sconfig.traffic, device=str(dev),
        records=_serve_records(engine_res), swaps=engine_res.swaps,
        slo=slo, timings=dict(engine_res.timings),
        accuracy_by_version=serve_engine.accuracy_by_version(engine_res),
        test_acc=slo["accuracy"],
        trace=tracer if tracer.enabled else None, raw=engine_res)
