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

Transformer LM configs (``configs.get_config``) on the ``sequential`` /
``executor`` backends run the paper's chapter schedule over blocks
(``core.pff_lm``; ``pff_exec.LMExecutor`` on N nodes, bit-exact against
the sequential ``train_chapters``), on real text through the BPE
encoder by default, and are scored by held-out CE:

    cfg = get_config("qwen2-0.5b")
    res = api.fit(cfg, None, chapters=2, steps_per_chapter=2, batch=4,
                  seq=256)                               # text_source
    res = api.fit(cfg, None, backend="executor", schedule="all_layers",
                  num_nodes=4, chapters=2, steps_per_chapter=2)
    res.eval_ce

Serving (``serve``) answers requests while the executor trains the model
underneath (train-while-serve: each freshly trained layer is
hot-published into the serving replica), or from a fixed snapshot:

    res = api.serve(PAPER_MLP, task, traffic="uniform", rate=2000.0,
                    schedule="all_layers", num_nodes=4)  # train + serve
    res.fit.params, res.swaps
    res = api.fit(PAPER_MLP, task, backend="executor", num_nodes=4,
                  serve=api.ServeConfig(traffic="zipf"))  # same, via fit
    res = api.serve(PAPER_MLP, task, params=res.params, traffic="uniform",
                    n_requests=1024, rate=2000.0, max_batch=64)
    res.slo["latency_p99_ms"], res.slo["consistency_violations"]

All of it runs on ``cuda`` unless ``device="cpu"`` is passed. Strategy
variation (negatives, goodness objective, classifier) is config-driven
through the registries re-exported here.

The ``pod`` backend (beyond-paper) trains an LM config's one stacked
group as a pipeline over ``num_nodes`` stages, one process each
(``core.pff_pod`` on ``torch.distributed``): under ``torchrun
--nproc_per_node N`` with the default group initialized, or in this
process alone when ``num_nodes == 1``:

    res = api.fit(get_config("qwen2-0.5b"), backend="pod", num_nodes=1,
                  steps=4, batch=4, seq=256)
    res.history, res.makespan, res.params
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import data as data_lib
from repro_torch.convert import tree_map
from repro_torch.core import ff_mlp, pff, pff_exec, pff_lm, pff_pod
from repro_torch.core import strategies
from repro_torch.core import train as train_lib
from repro_torch.core.rng import TorchKey
from repro_torch.core.faults import (        # noqa: F401  re-exported
    FaultPlan, ResilienceConfig,
)
from repro_torch.core.strategies import (    # noqa: F401  re-exported
    classifier, goodness, negatives,
    register_classifier, register_goodness, register_negatives,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import registry as kernel_registry
from repro_torch.launch import mesh as mesh_lib
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
    eval_ce: Optional[float] = None         # LM chapter backends: val CE
    serve: Optional["ServeResult"] = None   # fit(serve=ServeConfig(...))
    device: Optional[str] = None
    trace: Optional[object] = None          # obs.trace.Tracer (trace=...)
    raw: object = None


@dataclasses.dataclass
class ServeResult:
    """What ``serve`` returns: per-request lifecycle ``records``, the
    hot-swap timeline, per-phase ``timings`` and the ``.slo`` block
    (p50/p99 latency, throughput, shed rate, swaps, staleness,
    consistency violations), as the reference's ``ServeResult`` has
    them; in combined mode ``fit`` is the training side."""
    cfg: object
    traffic: str
    device: str
    schedule: Optional[str] = None          # None = serve-only (static)
    num_nodes: int = 1
    records: Optional[List[dict]] = None
    swaps: Optional[List[dict]] = None
    slo: Optional[dict] = None
    timings: Optional[dict] = None          # {"serve_s", ["train_s"]}
    accuracy_by_version: Optional[dict] = None
    test_acc: Optional[float] = None        # accuracy over served requests
    fit: Optional[FitResult] = None         # training side (combined mode)
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


def _recording(tracer):
    """``tracer`` installed as the program's active tracer, where it
    records."""
    return obs_trace.use(tracer) if tracer.enabled else \
        contextlib.nullcontext()


def fit(cfg, task=None, *, backend="sequential", schedule=None,
        num_nodes=1, probe_every=0, verbose=False, profile=False,
        devices=None, overlap=True, resilience=None, resume_from=None,
        serve=None, trace=None, comm_time=0.0, device=None,
        key=None, steps=40, chapters=4, steps_per_chapter=8, batch=8,
        seq=64, lr=1e-3, head_lr=None, impl="auto") -> FitResult:
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
    pod         an LM config's one stacked group as a pipeline of
                ``num_nodes`` stages, one process each
                (``core.pff_pod``), for ``steps`` steps of ``batch`` x
                ``seq`` tokens (``task``: an iterable of (batch, seq+1)
                token blocks, default ``data.lm_batches``). The stages
                are the processes of the default group (``torchrun
                --nproc_per_node num_nodes``); with no group,
                ``num_nodes`` must be 1. ``FitResult.params`` is the
                whole model (the stage rows gathered), ``history`` the
                per-step (step, FF loss).

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
    serve: executor: a ``ServeConfig``: train-while-serve (the executor
    hot-publishes every freshly trained layer into a serving replica,
    which serves the config's traffic concurrently); the serving side
    comes back on ``FitResult.serve``.
    trace: ``True`` or an ``obs.trace.Tracer``: one span around the
    backend's run, in ``FitResult.trace``; the sequential, federated and
    simulate backends and the LM paths also record their tasks and the
    program's spans inside them into it (``obs_trace.use``).
    device: ``None`` = ``cuda`` (raises without a GPU); ``"cpu"`` runs
    the plain PyTorch path.
    key: the run's random key (``core.rng``); default
    ``TorchKey(cfg.seed)``.

    Transformer LM configs on the sequential / executor backends run
    the chapter schedule (``core.pff_lm``: per-block train tasks and a
    per-chapter head task): ``task`` is a ``data.TextSource``-like
    source of token blocks (default ``data.text_source(cfg.vocab, seq,
    seed)``), sized by ``chapters`` x ``steps_per_chapter`` x ``batch``;
    ``head_lr`` overrides ``lr`` for the head task. The executor backend
    drives ``pff_exec.LMExecutor`` bit-exact against sequential; held-out
    CE comes back on ``FitResult.eval_ce``. ``impl`` routes the LM's
    no-grad forwards (frozen prefixes, the head task's forward, eval):
    "auto" = the CUDA attention / SSD kernels on the card, "ref" = the
    plain route throughout; differentiated forwards are always plain.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if (resilience is not None or resume_from is not None) \
            and backend != "executor":
        raise ValueError(
            f"resilience/resume_from are executor-backend features "
            f"(chapter checkpoints, fault injection, elastic "
            f"membership); got backend={backend!r}")
    if serve is not None and backend != "executor":
        raise ValueError(
            f"serve= runs the train-while-serve mode, which needs the "
            f"executor backend's live per-layer publication; got "
            f"backend={backend!r}")
    if serve is not None and not isinstance(serve, ServeConfig):
        raise TypeError(f"serve= expects an api.ServeConfig, got "
                        f"{type(serve).__name__}")
    if backend == "pod":
        tracer = obs_trace.as_tracer(trace)
        with tracer.span("fit:pod", num_nodes=num_nodes, steps=steps):
            fres = _fit_pod(cfg, task, num_nodes=num_nodes, steps=steps,
                            batch=batch, seq=seq, lr=lr, verbose=verbose,
                            device=device, key=key)
        fres.trace = tracer if tracer.enabled else None
        return fres
    if hasattr(cfg, "groups"):
        if backend not in ("sequential", "executor"):
            raise ValueError(
                f"LM configs run the chapter schedule on the sequential / "
                f"executor backends; got backend={backend!r}")
        if resilience is not None or resume_from is not None \
                or serve is not None:
            raise ValueError(
                "LM chapter schedules do not support resilience/"
                "resume_from/serve yet (ROADMAP: unify with lm_decode "
                "serving)")
        tracer = obs_trace.as_tracer(trace)
        with _recording(tracer):
            fres = _fit_lm_chapters(
                cfg, task, backend=backend, schedule=schedule,
                num_nodes=num_nodes, chapters=chapters,
                steps_per_chapter=steps_per_chapter, batch=batch, seq=seq,
                lr=lr, head_lr=head_lr, devices=devices, overlap=overlap,
                profile=profile, device=device, key=key, impl=impl,
                tracer=tracer)
        fres.trace = fres.trace or (tracer if tracer.enabled else None)
        return fres
    if impl != "auto":
        raise ValueError("impl= routes an LM config's forwards; an FF-MLP "
                         "config names its kernel in cfg.kernel_impl")
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
        if serve is not None:
            return _run_combined(cfg, ex, serve, source=None,
                                 resume_from=resume_from,
                                 schedule=schedule, num_nodes=num_nodes,
                                 tracer=tracer).fit
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
        with tracer.span("fit:federated", num_nodes=num_nodes), \
                _recording(tracer):
            res = pff.run_federated_schedule(cfg, task, num_nodes, **kw)
    elif backend == "sequential":
        schedule, num_nodes = "sequential", 1
        with tracer.span("fit:sequential"), _recording(tracer):
            res = pff.run_chapter_schedule(cfg, task, **kw)
    else:       # simulate: train once, replay the task times
        schedule = schedule or ("sequential" if num_nodes == 1
                                else "all_layers")
        with tracer.span("fit:simulate", schedule=schedule,
                         num_nodes=num_nodes), _recording(tracer):
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


def _serve_result(cfg, sconfig, engine_res, *, device, schedule=None,
                  num_nodes=1, fit_result=None,
                  tracer=obs_trace.NOOP) -> ServeResult:
    slo = serve_engine.summarize(engine_res)
    return ServeResult(
        cfg=cfg, traffic=sconfig.traffic, device=str(device),
        schedule=schedule, num_nodes=num_nodes,
        records=_serve_records(engine_res), swaps=engine_res.swaps,
        slo=slo, timings=dict(engine_res.timings),
        accuracy_by_version=serve_engine.accuracy_by_version(engine_res),
        test_acc=slo["accuracy"], fit=fit_result,
        trace=tracer if tracer.enabled else None, raw=engine_res)


def _run_combined(cfg, ex, sconfig, *, source, resume_from, schedule,
                  num_nodes, tracer=obs_trace.NOOP) -> ServeResult:
    """Train-while-serve: one executor run with live publication, one
    serve loop, results cross-linked (``ServeResult.fit`` /
    ``FitResult.serve``). One tracer is shared by the serve loop and the
    executor thread, so the trace has a single clock."""
    engine_res = serve_engine.train_while_serve(ex, sconfig, source,
                                                resume_from=resume_from,
                                                tracer=tracer)
    res = engine_res.exec_result
    dev = ex.devices[0]
    fit_res = FitResult(backend="executor", cfg=cfg, params=res.params,
                        schedule=schedule, num_nodes=num_nodes,
                        records=res.records, test_acc=res.test_acc,
                        makespan=res.makespan, resilience=res.resilience,
                        device=str(dev), trace=res.trace, raw=res)
    sres = _serve_result(cfg, sconfig, engine_res, device=dev,
                         schedule=schedule, num_nodes=num_nodes,
                         fit_result=fit_res, tracer=tracer)
    fit_res.serve = sres
    return sres


def serve(cfg, task=None, *, traffic=None, source=None, params=None,
          schedule=None, num_nodes=1, devices=None, overlap=True,
          resilience=None, resume_from=None, serve_cfg=None, trace=None,
          device=None, key=None, **knobs) -> ServeResult:
    """Serve the config's classifier under deterministic open-loop
    traffic, while TRAINING it live on the executor (the default), or
    from a fixed ``params`` snapshot (serve-only replay).

    traffic: a name from the ``traffic`` registry (uniform / zipf /
    bursty, or anything added with ``register_traffic``).
    source: a ``data.Source`` for request payloads; defaults to the
    task's test split (``data.source_of``).
    params: a params dict of tensors (``ff_mlp.init``'s layout, or a
    reference tree through ``convert.params_from_numpy``), moved to
    ``device``: serve-only mode, one static snapshot at version 0
    (``n_requests`` bounds the run, default 256).
    schedule / num_nodes / devices / overlap / resilience / resume_from
    / key: the executor's knobs, as ``fit(backend="executor")`` takes
    them (combined mode only): the loop serves until training ends, then
    ``final_probe`` more requests at the final weights.
    serve_cfg / **knobs: a ``ServeConfig``, and/or its fields as
    keywords (``rate=...``, ``max_batch=...``, ``max_wait_s=...``,
    ``queue_cap=...``, ``n_requests=...``, ``seed=...``,
    ``final_probe=...``); keywords win.
    trace: ``True`` or an ``obs.trace.Tracer``: record admission /
    batch-form / score / swap-install spans (and, in combined mode, the
    executor's task spans on the same clock) into ``ServeResult.trace``.
    Combined mode: the default tracer blocks training after every task;
    pass ``Tracer(block_tasks=False)`` to watch serving under the real
    overlapped training load.
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
    tracer = obs_trace.as_tracer(trace)
    if source is None:
        if task is None:
            raise ValueError("serve needs a task or an explicit "
                             "source= for request payloads")
        source = data_lib.source_of(task)

    if params is not None:
        dev = resolve_device(device)
        if sconfig.n_requests is None:
            sconfig = dataclasses.replace(sconfig, n_requests=256)
        engine_res = serve_engine.serve_static(
            tree_map(lambda t: t.to(dev), params), cfg, source, sconfig,
            eval_mode=good.eval_mode(cfg), impl=ff_mlp.kernel_impl(cfg),
            tracer=tracer)
        return _serve_result(cfg, sconfig, engine_res, device=dev,
                             tracer=tracer)

    if task is None:
        raise ValueError("train-while-serve needs the training task "
                         "(pass params= for serve-only)")
    schedule = schedule or ("sequential" if num_nodes == 1
                            else "all_layers")
    ex = pff_exec.PFFExecutor(
        cfg, task, schedule, num_nodes, devices=devices, overlap=overlap,
        resilience=resilience,
        device=None if devices is not None else resolve_device(device),
        key=key)
    return _run_combined(cfg, ex, sconfig, source=source,
                         resume_from=resume_from, schedule=schedule,
                         num_nodes=num_nodes, tracer=tracer)


def _fit_pod(cfg, task, *, num_nodes, steps, batch, seq, lr, verbose,
             device, key) -> FitResult:
    """The pod-pipeline backend (LM configs): a (num_nodes, 1, 1) mesh
    of (stage, data, model) over the default process group, or no mesh
    for one stage without a group. Every rank initializes the whole
    model from the config's seed, keeps its stage's rows, trains them,
    and gathers the stacked group back at the end."""
    if not hasattr(cfg, "groups"):
        raise ValueError(
            "backend=\"pod\" expects a transformer LM config "
            "(repro_torch.configs.get_config(...)); FF-MLP configs run on "
            "the sequential/federated/executor/simulate backends")
    from repro_torch.launch.dryrun import refuse_port_only

    refuse_port_only(cfg, "the pod pipeline (backend=\"pod\")")
    stages = num_nodes
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != stages:
            raise ValueError(
                f"pod backend: num_nodes={stages} stages, but the default "
                f"process group has {dist.get_world_size()} processes")
        mesh = mesh_lib.make_mesh((stages, 1, 1), ("stage", "data", "model"))
    elif stages == 1:
        mesh = None
    else:
        raise RuntimeError(
            f"pod backend with num_nodes={stages} needs one process per "
            f"stage: launch with torchrun --nproc_per_node {stages} and "
            f"call torch.distributed.init_process_group first")
    seed = getattr(cfg, "seed", 0) or 0
    key_fn = TorchKey if key is None else (lambda _seed: key)
    step_fn = pff_pod.make_pff_pod_step(cfg, mesh, lr=lr, seed=seed,
                                        key_fn=key_fn)
    params = pff_lm.init_params(cfg, seed, dev)
    params["groups"] = (pff_pod.stage_rows(params["groups"][0], mesh),)
    opt = pff_pod.init_opt_state(params)
    inflight = pff_pod.init_inflight(cfg, batch, seq, mesh, device=dev)
    batches = (task if task is not None
               else data_lib.lm_batches(cfg.vocab, batch, seq, steps))
    history = []
    t0 = time.perf_counter()
    for i, tokens in enumerate(batches):
        params, opt, inflight, m = step_fn(
            params, opt, {"tokens": torch.as_tensor(tokens, device=dev)},
            inflight, i + 1)
        history.append((i + 1, float(m["loss_ff"])))
        if verbose and (i + 1) % 10 == 0:
            print(f"  pod step {i + 1}: FF loss {history[-1][1]:.4f}")
    params["groups"] = (pff_pod.gather_stage_rows(params["groups"][0],
                                                  mesh),)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    makespan = time.perf_counter() - t0
    return FitResult(backend="pod", cfg=cfg, params=params,
                     schedule="pod_pipeline", num_nodes=stages,
                     history=history, makespan=makespan, device=str(dev),
                     raw=history)


def _fit_lm_chapters(cfg, source, *, backend, schedule, num_nodes,
                     chapters, steps_per_chapter, batch, seq, lr, head_lr,
                     devices, overlap, profile, device, key, impl,
                     tracer=obs_trace.NOOP) -> FitResult:
    """LM chapter-schedule backends: sequential = ``pff_lm.
    train_chapters``, executor = ``pff_exec.LMExecutor``. Both consume
    the same source through the same ``chapter_batches`` stream and are
    scored by the same held-out ``train.eval_ce``, so the bit-exactness
    gate extends to the reported CE. ``key``: the root key of the
    negatives (folded by the step number); default ``TorchKey(seed)``.
    A config that reads stub frontend embeddings is refused
    (``pff_lm.check_chapter_config``)."""
    pff_lm.check_chapter_config(cfg)
    seed = getattr(cfg, "seed", 0) or 0
    key_fn = TorchKey if key is None else (lambda _seed: key)
    dev = (None if backend == "executor" and devices is not None
           else resolve_device(device))
    if source is None:
        source = data_lib.text_source(vocab=cfg.vocab, seq_len=seq,
                                      seed=seed)
    if backend == "sequential":
        data_iter = pff_lm.chapter_batches(source, batch=batch,
                                           steps=steps_per_chapter,
                                           device=dev)
        with tracer.span("fit:lm_sequential", chapters=chapters):
            t0 = time.perf_counter()
            params, records, losses = pff_lm.train_chapters(
                cfg, data_iter, chapters=chapters,
                steps_per_chapter=steps_per_chapter, lr=lr,
                head_lr=head_lr, seed=seed, key_fn=key_fn, impl=impl,
                device=dev)
            makespan = time.perf_counter() - t0
        fres = FitResult(backend=backend, cfg=cfg, params=params,
                         schedule="sequential", num_nodes=1,
                         records=records, makespan=makespan,
                         history=[(i + 1, l)
                                  for i, l in enumerate(losses)],
                         device=str(dev))
    else:
        schedule = schedule or ("sequential" if num_nodes == 1
                                else "all_layers")
        ex = pff_exec.LMExecutor(
            cfg, source, schedule, num_nodes, chapters=chapters,
            steps_per_chapter=steps_per_chapter, batch=batch, lr=lr,
            head_lr=head_lr, seed=seed, devices=devices, overlap=overlap,
            device=dev, key_fn=key_fn, impl=impl)
        res = ex.run(profile=profile,
                     trace=tracer if tracer.enabled else None)
        dev = ex.devices[0]
        fres = FitResult(backend=backend, cfg=cfg, params=res.params,
                         schedule=schedule, num_nodes=num_nodes,
                         records=res.records, makespan=res.makespan,
                         profile=({"node_busy": res.node_busy}
                                  if res.node_busy is not None
                                  else None),
                         device=str(dev), trace=res.trace, raw=res)
    # one eval path for both backends: held-out CE on a fixed val draw
    ev = torch.as_tensor(source.blocks("val", 16, seed=321), device=dev)
    fres.eval_ce = float(train_lib.eval_ce(fres.params, cfg, ev,
                                           impl=impl))
    return fres
