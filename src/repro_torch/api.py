"""``repro_torch.api`` — the port's facade (``repro.api``'s counterpart).

This slice serves a fixed parameter snapshot:

    import torch
    from repro_torch import api, data
    from repro_torch.configs.ff_mlp import PAPER_MLP
    from repro_torch.core import ff_mlp

    task = data.mnist_like(n_train=64, n_test=1000)
    params = ff_mlp.init(PAPER_MLP, torch.Generator().manual_seed(0))
    res = api.serve(PAPER_MLP, task, params=params, traffic="uniform",
                    n_requests=1024, rate=2000.0, max_batch=64)
    res.slo["latency_p99_ms"], res.slo["consistency_violations"]

It runs on ``cuda`` unless ``device="cpu"`` is passed. Training
(``fit``) and train-while-serve come with later slices; ``serve``
without ``params`` raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch import data as data_lib
from repro_torch.convert import tree_map
from repro_torch.core import ff_mlp, strategies
from repro_torch.device import resolve_device
from repro_torch.kernels import registry as kernel_registry
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import engine as serve_engine
from repro_torch.serve.engine import ServeConfig       # noqa: F401  re-export
from repro_torch.serve.traffic import register_traffic, traffic  # noqa: F401

__all__ = ["serve", "ServeResult", "ServeConfig", "traffic",
           "register_traffic"]


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
    (goodness, classifier and kernel impl; negatives come with
    training)."""
    good = strategies.goodness.get(cfg.goodness_fn)
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
            "train-while-serve needs the PFF executor, which the port has "
            "not reached yet; pass params= to serve a fixed snapshot")
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
