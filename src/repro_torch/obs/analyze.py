"""Trace analysis: critical path over ``pff_dag.deps``, busy/idle,
hand-off attribution, and makespan decomposition (the port's own copy of
``repro.obs.analyze``).

Consumes the plain trace-dict form (``Tracer.to_dict()``,
``export.load_jsonl(path)``) produced by a traced executor run. The
executor writes one ``task:<kind>`` span per DAG task (attrs ``kind``/
``layer``/``chapter``/``node``) and one closing ``run`` span carrying
the DAG shape (``schedule``/``num_nodes``/``splits``/``n_layers``/
``has_head``/``has_neg``/``strict_neg``), so the analyzer can rebuild
the exact dependency structure from ``repro_torch.core.pff_dag``, the
same single source of truth the simulator and executor walk, and answer
the questions counters cannot:

* critical path: the heaviest dependency chain through the observed
  task durations. The executor's measured makespan must sit between
  the critical path (can't go faster) and serial execution (the sum of
  task durations, or a measured N=1 run on shared-core hosts):
  ``check_invariants`` gates on exactly that.
* per-node busy/idle against the run window.
* hand-off attribution: prefetch hits are transfers that completed
  before the consumer needed them (their cost is OFF the critical
  path); cross-node pulls are synchronous copies ON the consumer's
  path.
* makespan decomposition: critical-path seconds, parallel slack (work
  hidden by overlap), and the residual scheduling/dispatch gap.

Durations only mean device time when the trace was recorded with
``Tracer(block_tasks=True)`` (the default: the executor synchronizes
the node's stream before closing each task span); dispatch-only traces
still analyze but the inequality gates are meaningless for them.
Retried tasks contribute the SUM of their attempts' spans (retries
serialize on the owning node).

This module imports no torch (``pff_dag`` is pure Python), so traces
can be analyzed offline. ``chip_smoke.py`` (phase 17) and
``tests/test_torch_pff_exec.py`` gate a traced executor run with
``check_invariants``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import pff_dag

# event names the executor's hand-off slots emit (see pff_exec._Handoff)
PREFETCH_HIT = "handoff:prefetch_hit"
PREFETCH_ISSUE = "handoff:prefetch_issue"
PULL_CROSS = "handoff:pull_cross"
PULL_LOCAL = "handoff:pull_local"


@dataclasses.dataclass
class TraceAnalysis:
    schedule: str
    num_nodes: int
    splits: int
    n_layers: int
    makespan: float                    # run-span duration (traced run)
    critical_path: List[Tuple[str, int, int]]   # (kind, layer, chapter)
    critical_path_s: float
    sum_task_s: float
    node_busy: Dict[int, float]
    node_idle: Dict[int, float]
    handoff: Dict[str, int]
    decomposition: Dict[str, float]
    counters: Dict[str, float]

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["critical_path"] = [list(t) for t in self.critical_path]
        return d


def _as_dict(trace) -> Dict[str, Any]:
    return trace if isinstance(trace, dict) else trace.to_dict()


def _run_span(spans: List[dict]) -> Optional[dict]:
    runs = [s for s in spans if s["name"] == "run"]
    return runs[-1] if runs else None


def analyze(trace, *, measured_makespan: Optional[float] = None
            ) -> TraceAnalysis:
    """Reconstruct the chapter-task critical path and timing breakdown
    from a traced executor run.

    measured_makespan: a separately measured (untraced, overlap-intact)
    makespan for the decomposition's gap line; defaults to the traced
    run's own window.
    """
    td = _as_dict(trace)
    spans = td.get("spans", [])
    events = td.get("events", [])
    run = _run_span(spans)
    if run is None:
        raise ValueError("trace has no 'run' span — was it recorded by "
                         "PFFExecutor.run(trace=...)?")
    ra = run.get("attrs", {})
    schedule = ra.get("schedule", "?")
    num_nodes = int(ra.get("num_nodes", 1))
    splits = int(ra.get("splits", 0))
    n_layers = int(ra.get("n_layers", 0))
    run_t0, run_t1 = float(run["t0"]), float(run["t1"])
    makespan = run_t1 - run_t0

    # --- per-task durations (sum over retry attempts) -------------------
    dur: Dict[Tuple[str, int, int], float] = {}
    node_of_task: Dict[Tuple[str, int, int], int] = {}
    task_windows: Dict[int, List[Tuple[float, float]]] = {}
    busy: Dict[int, float] = {n: 0.0 for n in range(num_nodes)}
    for s in spans:
        if not s["name"].startswith("task:"):
            continue
        a = s.get("attrs", {})
        key = (a["kind"], int(a["layer"]), int(a["chapter"]))
        d = float(s["t1"]) - float(s["t0"])
        dur[key] = dur.get(key, 0.0) + d
        node = int(a.get("node", 0))
        node_of_task[key] = node
        busy[node] = busy.get(node, 0.0) + d
        task_windows.setdefault(node, []).append(
            (float(s["t0"]), float(s["t1"])))
    if not dur:
        raise ValueError("trace has no task:* spans")
    sum_task_s = sum(dur.values())
    idle = {n: max(makespan - b, 0.0) for n, b in busy.items()}

    # --- longest path over pff_dag.deps ---------------------------------
    # elastic federated runs execute whole rounds as single tasks
    # (kind="round"); their dependency structure is a plain chain.
    cp_tasks, cp_len = _critical_path(
        dur, splits=splits, n_layers=n_layers,
        has_head=bool(ra.get("has_head", False)),
        has_neg=bool(ra.get("has_neg", False)),
        strict_neg=bool(ra.get("strict_neg", False)))

    # --- hand-off attribution -------------------------------------------
    cp_set = set(cp_tasks)
    counts = {PREFETCH_HIT: 0, PREFETCH_ISSUE: 0, PULL_CROSS: 0,
              PULL_LOCAL: 0}
    hits_inside_task = 0
    cross_on_cp = 0
    for e in events:
        if e["name"] not in counts:
            continue
        counts[e["name"]] += 1
        node = int(e.get("attrs", {}).get("node", -1))
        inside = any(t0 <= float(e["t"]) <= t1
                     for t0, t1 in task_windows.get(node, ()))
        if e["name"] == PREFETCH_HIT and inside:
            hits_inside_task += 1
        if e["name"] == PULL_CROSS:
            # a miss stalls whichever task consumed it; if that task is
            # on the critical path the wait is pure makespan
            key = _task_at(e, task_windows, node, spans)
            if key is not None and key in cp_set:
                cross_on_cp += 1
    handoff = {
        "prefetch_issued": counts[PREFETCH_ISSUE],
        "prefetch_hits": counts[PREFETCH_HIT],
        "pulls_cross": counts[PULL_CROSS],
        "pulls_local": counts[PULL_LOCAL],
        # a hit == the transfer landed before the consumer asked: its
        # cost is off the critical path by construction
        "off_critical_path": counts[PREFETCH_HIT],
        "on_critical_path": cross_on_cp,
        "hits_inside_task_spans": hits_inside_task,
    }

    m = measured_makespan if measured_makespan is not None else makespan
    decomposition = {
        "critical_path_s": cp_len,
        "parallel_slack_s": max(sum_task_s - cp_len, 0.0),
        "makespan_gap_s": m - cp_len,
        "measured_makespan_s": m,
    }
    return TraceAnalysis(
        schedule=schedule, num_nodes=num_nodes, splits=splits,
        n_layers=n_layers, makespan=makespan,
        critical_path=list(cp_tasks), critical_path_s=cp_len,
        sum_task_s=sum_task_s, node_busy=busy, node_idle=idle,
        handoff=handoff, decomposition=decomposition,
        counters=dict(td.get("counters", {})))


def _task_at(event, task_windows, node, spans
             ) -> Optional[Tuple[str, int, int]]:
    """The (kind, layer, chapter) of the task span enclosing an event
    on its node, if any."""
    t = float(event["t"])
    for s in spans:
        if not s["name"].startswith("task:"):
            continue
        a = s.get("attrs", {})
        if int(a.get("node", -2)) == node and \
                float(s["t0"]) <= t <= float(s["t1"]):
            return (a["kind"], int(a["layer"]), int(a["chapter"]))
    return None


def _critical_path(dur: Dict[Tuple[str, int, int], float], *,
                   splits: int, n_layers: int, has_head: bool,
                   has_neg: bool, strict_neg: bool
                   ) -> Tuple[List[Tuple[str, int, int]], float]:
    """Longest weighted chain through the observed tasks using
    ``pff_dag.deps`` edges (restricted to tasks actually in the trace —
    a resumed run's trace only covers the replay frontier)."""
    # canonical order is a valid topological order; "round" tasks
    # (elastic federated) form their own per-chapter chain
    order: List[Tuple[str, int, int]] = []
    if any(k == "round" for k, _, _ in dur):
        order = sorted((key for key in dur if key[0] == "round"),
                       key=lambda key: key[2])
        edges = {key: ([("round", -1, key[2] - 1)] if key[2] > 0 else [])
                 for key in order}
    else:
        edges = {}
        for t in pff_dag.build_tasks(n_layers, splits, has_head=has_head,
                                     has_neg=has_neg):
            key = (t.kind, t.layer, t.chapter)
            if key not in dur:
                continue
            order.append(key)
            edges[key] = [
                (d.kind, d.layer, d.chapter)
                for d in pff_dag.deps(t, n_layers, has_head=has_head,
                                      has_neg=has_neg,
                                      strict_neg=strict_neg)
                if (d.kind, d.layer, d.chapter) in dur]
    dist: Dict[Tuple[str, int, int], float] = {}
    pred: Dict[Tuple[str, int, int], Optional[Tuple[str, int, int]]] = {}
    for key in order:
        best, bp = 0.0, None
        for d in edges[key]:
            if dist[d] > best:
                best, bp = dist[d], d
        dist[key] = best + dur[key]
        pred[key] = bp
    end = max(dist, key=lambda key: dist[key])
    path: List[Tuple[str, int, int]] = []
    cur: Optional[Tuple[str, int, int]] = end
    while cur is not None:
        path.append(cur)
        cur = pred[cur]
    path.reverse()
    return path, dist[end]


def check_invariants(analysis: TraceAnalysis, measured_makespan: float,
                     *, serial_makespan: Optional[float] = None,
                     slack: float = 1.02) -> List[str]:
    """The trace-smoke gate: critical path <= measured makespan <=
    serial execution, with a small tolerance for clock jitter between
    the traced and the timed run.

    The serial bound is the sum of task durations by default — exact
    when each faked device owns a real core. On a shared-core container
    the parallel run contends for cores the blocked per-task
    measurements had to themselves, and the schedule window also pays
    driver/hand-off time outside any task span, so callers there pass
    ``serial_makespan`` (a measured N=1 run under the SAME contention,
    the convention of ``chip_smoke.py``'s executor phase) and the gate
    takes the
    larger of the two bounds.
    """
    fails = []
    if analysis.critical_path_s > measured_makespan * slack:
        fails.append(
            f"critical path {analysis.critical_path_s:.3f}s exceeds "
            f"measured makespan {measured_makespan:.3f}s — task spans "
            f"are not real device time?")
    bound = max(analysis.sum_task_s, serial_makespan or 0.0)
    if measured_makespan > bound * slack:
        fails.append(
            f"measured makespan {measured_makespan:.3f}s exceeds the "
            f"serial bound {bound:.3f}s (sum of task durations "
            f"{analysis.sum_task_s:.3f}s"
            + (f", measured serial run {serial_makespan:.3f}s"
               if serial_makespan else "")
            + ") — schedule ran slower than serial execution")
    return fails
