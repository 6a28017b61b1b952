"""The PFF executor: the paper's schedules run for real, one node per
paper "node" (the port of ``repro.core.pff_exec``'s ``PFFExecutor``).

Where ``core.pff`` times the canonical chapter schedule once and
REPLAYS the timings through an event-driven simulator, this module RUNS
the Single-Layer, All-Layers and Federated schedules with one node per
paper node. A node is a device plus, on the card, a CUDA stream of its
own (``launch.mesh.pff_node_devices``: N x ``cuda:0`` on one H100, N x
``cpu`` in the tests, where the nodes run in order). The chapter-task
DAG and the per-schedule node assignments come from ``core.pff_dag``,
the module the simulator replays.

Execution model: the drivers dispatch tasks in the DAG's canonical
order and never wait for the card. Every task body runs inside its
node's stream (``torch.cuda.stream``), so the kernels' launches, their
scratch, the epoch permutations' host-to-device copies and Adam's
updates all land on that stream; the card overlaps the streams where
the host enqueues faster than they drain. Makespan is wall-clock from
the first dispatch to every stream drained.

Bit-exactness: the DAG fixes the weight-update order, and every task
body makes exactly the calls of the sequential trainer
(``good.train_chapter``, ``ff_mlp.fwd_norm``, ``train_head_chapter``,
``neg.fn``, ``pff._class_scores_chunked``) with the same keys and
learning rates, so the executor reproduces ``pff.run_chapter_schedule``'s
weight stream bit for bit (and Federated's against the federated
backend). That is the correctness oracle of
``tests/test_torch_pff_exec.py`` and ``chip_smoke.py``.

Hand-off (``_Handoff``): the trainers update params and Adam state IN
PLACE (the counterpart of the reference's donated buffers), so a tree
that crosses from one node to another is always COPIED
(``_Nodes.move``): the copy runs on the producer's stream, right after
the producing task and before anything the producer does next (so a
later in-place update of the producer's own tree cannot race it); the
consumer's stream waits on an event recorded after the copy, and
``record_stream`` tells the caching allocator that the consumer's
stream uses the copy. That copy is the double buffer. With
``overlap=True`` (the default) it is issued the moment the producing
task has been dispatched (``prefetch``) toward the consumers
``pff_dag.handoff_targets`` names, tagged with the producing chapter; a
consumer takes the parked copy only when the version matches what it
would have pulled on demand (``take``), else it pulls then. A pull from
the node that holds the tree is local and copies nothing, as the
sequential trainer copies nothing. ``overlap=False`` restores the
serialize-on-demand hand-off for A/B runs; the weight stream is
bit-identical either way.

Resilience (``faults.ResilienceConfig`` via ``api.fit(...,
resilience=...)``), as the reference has it: because the DAG has no
backward edges, a completed chapter is a consistent recovery line
(``pff_dag.replay_frontier``). (1) After chapter c an atomic manifest
(node states + head + published negatives + hand-off versions,
``repro_torch.checkpoint`` with ``meta``/``strict``, the reference's
file format) lands in ``checkpoint_dir``; ``run(resume_from=...)``
replays from the next chapter bit-exactly. (2) An injected crash
(``faults.FaultPlan``) fires at task ENTRY, before any hand-off take or
in-place update, so a retry (exponential backoff) re-dispatches the
identical task. (3) On budget exhaustion the node is declared dead:
all_layers / single_layer remap its logical node to a surviving node's
device and stream (same math, still bit-exact); federated rolls the
chapter back and drops the dead node's shard. (4) Elastic federated
membership: every live node trains a copy of the round-start model on
its own shard and node 0 averages them weighted by live shard sizes,
bit-checked against ``pff.run_elastic_federated`` (both call
``pff.elastic_node_round``).

Observability (``repro_torch.obs``): ``run(trace=...)`` records one
``task:<kind>`` span per DAG task, ``handoff:*`` events,
``resilience:*`` events and counters, and a closing ``run`` span with
the DAG shape, everything ``obs.analyze`` needs. With the default
``Tracer(block_tasks=True)`` (or ``profile=True``) each task span ends
after its node's stream is synchronized, so spans are device time and
``ExecResult.records`` feed ``pff.simulate_schedule``.

``LMExecutor`` runs the LM chapter schedule (``core.pff_lm``) the same
way, bit-exact against ``pff_lm.train_chapters``.

``python -m repro_torch.core.pff_exec`` runs the reference's selftest
cases (``--matrix``, ``--lm-matrix``, one schedule, or a resilience case with
``--fault-plan`` / ``--checkpoint-dir`` / ``--resume-from``) on
``--device`` (default ``cuda``).
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import checkpoint as checkpoint_lib, data as data_lib, optim
from repro_torch.convert import tree_leaves, tree_map, tree_stack
from repro_torch.core import faults as faults_lib
from repro_torch.core import ff, ff_mlp, pff, pff_dag, pff_lm, strategies
from repro_torch.core.rng import TorchKey
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class ExecResult:
    params: dict
    schedule: str
    num_nodes: int
    makespan: float                        # seconds, first dispatch -> drained
    test_acc: Optional[float]
    records: Optional[List[pff.TaskRecord]]  # per-task durations (traced)
    node_busy: Optional[List[float]]         # per-node busy seconds (traced)
    handoff: Optional[dict] = None           # transfer-slot counters
    resilience: Optional[dict] = None        # retry/checkpoint/fault stats
    trace: Optional[object] = None           # obs.trace.Tracer, if traced


def _records_from_spans(tracer, span0, num_nodes):
    """(records, node_busy) derived from the ``task:*`` spans of one run,
    so ``pff.simulate_schedule`` replays traced runs."""
    records = []
    node_busy = [0.0] * num_nodes
    for s in tracer.snapshot(start=span0):
        if not s.name.startswith("task:"):
            continue
        a = s.attrs
        records.append(pff.TaskRecord(a["kind"], a["layer"],
                                      a["chapter"], s.duration))
        node_busy[a["node"]] += s.duration
    return records, node_busy


class _ShardDropped(Exception):
    """Raised inside a federated chapter when its owning node dies with
    the retry budget exhausted: the run loop rolls the chapter back and
    drops that node's shard for the round (graceful degradation)."""

    def __init__(self, node):
        super().__init__(f"node {node} dead; shard dropped this round")
        self.node = node


def checkpoint_path(directory: str, chapter: int) -> str:
    """Canonical chapter-manifest filename (the reference's)."""
    return os.path.join(directory, f"pff_chapter_{chapter:04d}.npz")


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest (highest-chapter) manifest in ``directory``, or None."""
    paths = glob.glob(os.path.join(directory, "pff_chapter_*.npz"))
    if not paths:
        return None
    return max(paths, key=lambda p: int(
        re.search(r"pff_chapter_(\d+)\.npz$", p).group(1)))


def _node_devices(num_nodes, devices, device):
    """The nodes' devices: ``devices`` (the first ``num_nodes``; a
    repeated device is allowed), else ``pff_node_devices(num_nodes,
    device)``."""
    if devices is None:
        return mesh_lib.pff_node_devices(num_nodes, device)
    devs = [resolve_device(d) for d in list(devices)[:num_nodes]]
    if len(devs) != num_nodes:
        raise ValueError(f"{num_nodes} nodes need {num_nodes} devices, got "
                         f"{len(devs)}")
    return devs


class _Nodes:
    """The executor's logical nodes: a device each and, on the card, a
    CUDA stream each (N x ``cuda:0`` gives N streams on one card).

    ``on(node)`` makes the node's stream current. ``move`` hands a tree
    from one node to another (see the module docstring); ``share`` lets
    every node read tensors made on the current stream before the run;
    ``remap`` gives a dead node's work to a survivor; ``sync`` waits on
    the host for the nodes' streams."""

    def __init__(self, devices):
        self.devices = list(devices)
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"the executor's nodes must all be cuda or all "
                             f"cpu devices, got {self.devices}")
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self._init = (list(self.devices), list(self.streams))

    def reset(self):
        """Undo a previous run's dead-node remaps."""
        self.devices[:] = self._init[0]
        self.streams[:] = self._init[1]

    def on(self, node):
        return torch.cuda.stream(self.streams[node])

    def _distinct_streams(self):
        seen = []
        for s in self.streams:
            if s is not None and all(s is not t for t in seen):
                seen.append(s)
        return seen

    def move(self, tree, src, dst, *, copy=True):
        """``tree``, made on node ``src``'s stream, for node ``dst``: a
        copy (or the tree itself with ``copy=False``, read-only use) that
        ``dst``'s stream may use once everything ``src`` enqueued before
        it has run."""
        dev = self.devices[dst]
        s_src, s_dst = self.streams[src], self.streams[dst]
        if copy or self.devices[src] != dev:
            with torch.cuda.stream(s_src):
                tree = tree_map(lambda t: t.to(dev, copy=True), tree)
        if s_src is not None and s_src is not s_dst:
            ev = torch.cuda.Event()
            ev.record(s_src)
            s_dst.wait_event(ev)
            for t in tree_leaves(tree):
                t.record_stream(s_dst)
        return tree

    def share(self, tree):
        """Tensors made on the current stream, which every node reads:
        each node's stream waits for them, and the allocator knows."""
        streams = self._distinct_streams()
        if not streams:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.devices[0]))
        for s in streams:
            s.wait_event(ev)
        for t in tree_leaves(tree):
            if t is not None:
                for s in streams:
                    t.record_stream(s)

    def remap(self, node, to):
        """Node ``node`` runs on node ``to``'s device and stream from
        now on, after everything it has enqueued."""
        old, new = self.streams[node], self.streams[to]
        if old is not None and old is not new:
            ev = torch.cuda.Event()
            ev.record(old)
            new.wait_event(ev)
        self.devices[node], self.streams[node] = self.devices[to], new

    def sync(self, node=None):
        """The host waits for ``node``'s stream (every node's when
        None)."""
        streams = (self._distinct_streams() if node is None
                   else [self.streams[node]])
        for s in streams:
            if s is not None:
                s.synchronize()


class _Handoff:
    """Double-buffered transfer slots for the DAG hand-off.

    ``prefetch`` copies a tree from the producing node ``src`` toward its
    future consumer (``_Nodes.move``) and parks it under ``(name, node)``
    tagged with the producing chapter. ``take`` returns the parked copy
    iff the version matches what the consumer would have pulled on
    demand; otherwise (or with overlap disabled) it pulls then: a copy
    from another node (``pulls_cross``), or the holder's own tree when
    the consumer holds it (``pulls_local``, no copy). Slots whose trees
    the consumer trains in place are popped on hit (``pop=True``);
    params-only slots stay parked so several same-chapter consumers on
    one node share a single transfer.

    Fault hooks (``fault_cb``, ``faults.FaultPlan.handoff_action``): a
    "drop" fault loses the transfer (the consumer's on-demand pull IS
    the recovery path); a "corrupt" fault parks the copy NaN-poisoned
    with the slot's integrity flag set, and ``take`` re-pulls instead of
    serving it (``corrupt_detected``).
    """

    def __init__(self, nodes: _Nodes, enabled: bool, fault_cb=None,
                 tracer=obs_trace.NOOP):
        self.nodes = nodes
        self.enabled = enabled
        self.fault_cb = fault_cb
        self.tracer = tracer
        self.slots: Dict[tuple, tuple] = {}   # (name, node) -> (ver, tree, corrupt)
        self.stats = {"prefetch_issued": 0, "prefetch_hits": 0,
                      "pulls_cross": 0, "pulls_local": 0,
                      "prefetch_dropped": 0, "corrupt_injected": 0,
                      "corrupt_detected": 0}

    def _event(self, name, slot_name, node, version):
        # every counter bump mirrors onto the tracer timeline, so the
        # analyzer's attribution reconciles with these stats exactly
        if self.tracer.enabled:
            self.tracer.event(name, tree=str(slot_name[0]), node=node,
                              version=version)

    def prefetch(self, name, node: int, version: int, tree, *, src: int):
        if not self.enabled:
            return
        corrupt = False
        if self.fault_cb is not None:
            action = self.fault_cb(name, node, version)
            if action == "drop":
                self.stats["prefetch_dropped"] += 1
                self._event("handoff:drop", name, node, version)
                return
            corrupt = action == "corrupt"
        copy = self.nodes.move(tree, src, node)
        if corrupt:
            with self.nodes.on(node):
                for t in tree_leaves(copy):
                    if t.is_floating_point():
                        t.fill_(float("nan"))
            self.stats["corrupt_injected"] += 1
        self.slots[(name, node)] = (version, copy, corrupt)
        self.stats["prefetch_issued"] += 1
        self._event("handoff:prefetch_issue", name, node, version)

    def take(self, name, node: int, version: int, tree, *, src: int,
             pop: bool = False):
        slot = self.slots.get((name, node))
        if slot is not None and slot[0] == version:
            if slot[2]:
                # integrity gate: poisoned bits are never served
                del self.slots[(name, node)]
                self.stats["corrupt_detected"] += 1
                self._event("handoff:corrupt_detected", name, node, version)
            else:
                if pop:
                    del self.slots[(name, node)]
                self.stats["prefetch_hits"] += 1
                self._event("handoff:prefetch_hit", name, node, version)
                return slot[1]
        local = src == node
        self.stats["pulls_local" if local else "pulls_cross"] += 1
        self._event("handoff:pull_local" if local else "handoff:pull_cross",
                    name, node, version)
        return tree if local else self.nodes.move(tree, src, node)

    def drop_node_slots(self, node: int):
        """Forget parked copies destined for a dead node."""
        for key in [k for k in self.slots if k[1] == node]:
            del self.slots[key]


class _NodeExecutor:
    """What both executors share: the nodes (``_Nodes``), the run's
    tracer, and whether tasks synchronize their stream (timeline mode).
    ``_run`` sets ``_tracer`` and ``_block`` for one run and clears
    them after it."""

    def __init__(self, devs):
        self._nodes = _Nodes(devs)
        self._tracer = obs_trace.NOOP
        self._block = False

    @property
    def devices(self):
        return self._nodes.devices

    @property
    def streams(self):
        return self._nodes.streams

    def _finish_task(self, node, kind, layer, chapter, t0):
        """Close one DAG task: synchronize the node's stream (timeline
        mode only: real device time, at the cost of overlap) and record
        the ``task:<kind>`` span."""
        if self._block:
            self._nodes.sync(node)
        tr = self._tracer
        if tr.enabled:
            tr.add_span("task:" + kind, t0, kind=kind, layer=layer,
                        chapter=chapter, node=node)


class PFFExecutor(_NodeExecutor):
    """Runs one PFF schedule for real on ``num_nodes`` nodes.

    devices: the nodes' devices (a repeated device is allowed: each node
    still gets its own stream); default ``pff_node_devices(num_nodes,
    device)``. device: ``None`` = ``cuda`` (raises without a GPU),
    ``"cpu"`` for the plain path. key: the run's random key (default
    ``TorchKey(cfg.seed)``), as ``pff.run_chapter_schedule`` takes it.
    params: the initial params (copied per run; default
    ``ff_mlp.init(cfg, key, devices[0])``). ``run()`` starts from them
    every call, unless ``carry=True`` continues from the state the last
    run left (``state()``).
    """

    def __init__(self, cfg, task: data_lib.ImageTask, schedule: str,
                 num_nodes: int, *, devices=None, overlap: bool = True,
                 resilience: Optional[faults_lib.ResilienceConfig] = None,
                 device=None, key=None, params=None):
        if schedule not in pff_dag.SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; expected "
                             f"one of {pff_dag.SCHEDULES}")
        if schedule == "sequential" and num_nodes != 1:
            raise ValueError("sequential means num_nodes=1")
        super().__init__(_node_devices(num_nodes, devices, device))
        self.cfg = cfg
        self.task = task
        self.schedule = schedule
        self.num_nodes = num_nodes
        self.overlap = overlap
        self.key = TorchKey(cfg.seed) if key is None else key
        self.n_layers = len(cfg.layer_sizes) - 1
        self.C = max(cfg.epochs // cfg.splits, 1)
        self.impl = ff_mlp.kernel_impl(cfg)
        self.good = strategies.goodness.get(cfg.goodness_fn)
        self.neg = strategies.negatives.get(cfg.neg_mode)
        self.cls = strategies.classifier.get(cfg.classifier)
        self.has_head = self.cls.trains_head
        self.has_neg = self.good.uses_negatives and self.neg.regenerates
        self.resilience = resilience
        self.params0 = params
        self._next = None      # the chapter after the last run's last
        if resilience is not None and resilience.membership is not None:
            if schedule != "federated":
                raise ValueError(
                    "elastic membership is a Federated-PFF mode; got "
                    f"schedule={schedule!r}")
            if self.has_neg and self.neg.needs_scores:
                raise ValueError(
                    f"elastic federated membership supports key-only "
                    f"negative strategies; {cfg.neg_mode!r} needs "
                    f"full-model scores")
        self._const_dirty = False
        self._setup_constants()

    # ---- per-node constants (made once, before any timing) ---------------
    def _setup_constants(self):
        """The chapter-invariant inputs, as the sequential trainer makes
        them: one copy per device, shared by the nodes on it (read-only),
        plus each node's federated shard."""
        cfg, task = self.cfg, self.task
        self.kneg = self.key.fold_in(999)
        shards = None
        if self.schedule == "federated":
            # chapter c uses shard c % N, which IS node c % N's own shard
            shards = pff.federated_shards(cfg, task, self.num_nodes)
        by_dev = {}
        self._const: Dict[int, dict] = {}
        with torch.no_grad():
            for node, dev in enumerate(self._nodes.devices):
                if dev not in by_dev:
                    x = torch.as_tensor(task.x_train, device=dev)
                    y = torch.as_tensor(task.y_train, device=dev)
                    c = {"x": x, "y": y}
                    if self.good.uses_negatives:
                        c["xp0"] = ff_mlp._norm(ff.overlay_label(
                            x, y, cfg.num_classes))
                        c["xn0_init"] = ff_mlp._norm(self.neg.fn(
                            self.kneg, cfg, None, x, y, None))
                    else:
                        c["xk0"] = ff_mlp._norm(ff.overlay_neutral(
                            x, cfg.num_classes))
                    if self.has_head:
                        c["x_neutral"] = ff.overlay_neutral(
                            x, cfg.num_classes)
                    by_dev[dev] = c
                idx = (torch.as_tensor(shards[node], device=dev)
                       if shards is not None else None)
                self._const[node] = {**by_dev[dev], "idx": idx}
        self._nodes.share([c for c in self._const.values()])

    # ---- helpers ---------------------------------------------------------
    def _lrs(self, chapter):
        cfg, C = self.cfg, self.C
        lrs = torch.stack([
            optim.cooldown_lr(cfg.lr_ff, chapter * C + e, cfg.epochs,
                              cfg.cooldown_after) for e in range(C)])
        return lrs, lrs * (cfg.lr_softmax / cfg.lr_ff)

    def _layer_params(self, k, node):
        """Layer k's current params for ``node``: prefetched by the
        producing train task when the DAG says this node consumes them,
        pulled on demand otherwise."""
        return self._handoff.take(("params", k), node, self._ver[k],
                                  self._states[k][0], src=self._holder[k])

    def _prefetch_state(self, k, chapter, state, node):
        """Publish train(k, chapter)'s output toward its DAG consumers
        while the producing node is still crunching (double-buffering)."""
        nxt, param_nodes = pff_dag.handoff_targets(
            self.schedule, self.num_nodes, n_layers=self.n_layers,
            splits=self.cfg.splits, layer=k, chapter=chapter,
            has_head=self.has_head,
            has_neg=self.has_neg and self.neg.needs_scores)
        if nxt is not None:
            self._handoff.prefetch(("state", k), nxt, chapter, state,
                                   src=node)
        for p in param_nodes:
            self._handoff.prefetch(("params", k), p, chapter, state[0],
                                   src=node)

    def _fwd(self, lp, x):
        """One layer forward + Hinton length-norm, the inter-layer
        hand-off: the exact call the sequential trainer makes."""
        return ff_mlp.fwd_norm(lp, x, impl=self.impl)

    def _xn0_for(self, chapter, node):
        """The (full-size, normalized) negatives the sequential trainer
        would use for this chapter, for ``node`` (under its stream)."""
        const = self._const[node]
        if not self.has_neg or chapter == 0:
            return const["xn0_init"]
        if not self.neg.needs_scores:
            # key-only: each node regenerates its own copy, bit-identical
            # to the sequential trainer's by the key's determinism
            return ff_mlp._norm(self.neg.fn(
                self.kneg.fold_in(chapter - 1), self.cfg, None,
                const["x"], const["y"], None))
        # score-needing (AdaptiveNEG): published by chapter c-1's neg_gen
        src_chapter, xn0 = self._neg
        if src_chapter != chapter - 1:
            raise RuntimeError(f"negatives of chapter {src_chapter} where "
                               f"chapter {chapter - 1}'s are due")
        return self._handoff.take(("neg",), node, src_chapter, xn0,
                                  src=self._neg_holder)

    def _chapter_inputs(self, chapter, node):
        """(acts, extras) exactly as the sequential trainer builds them,
        on the node's stream."""
        const = self._const[node]
        idx = const["idx"]
        with self._nodes.on(node):
            if self.good.uses_negatives:
                xn0 = self._xn0_for(chapter, node)
                return ((const["xp0"] if idx is None else const["xp0"][idx],
                         xn0 if idx is None else xn0[idx]), ())
            return ((const["xk0"] if idx is None else const["xk0"][idx],),
                    (const["y"] if idx is None else const["y"][idx],))

    def _rtime(self, name, dt):
        """Resilience seconds into ``_rstats`` and the tracer's counters."""
        self._rstats[name] += dt
        self._tracer.counter(name, dt)

    # ---- resilience: fault consult, retry/backoff, death, checkpoints ----
    @property
    def _fault_plan(self):
        return (self.resilience.fault_plan
                if self.resilience is not None else None)

    def _resilient(self, kind, layer, chapter, node, body):
        """Run one task body under the resilience policy.

        Injected crashes fire at task ENTRY, before the hand-off take and
        any in-place update, so a retry re-dispatches the IDENTICAL task.
        Only ``faults.InjectedFault`` is caught. On budget exhaustion the
        node is declared dead and the loop continues: the crash check
        skips dead nodes, so the body then runs on the survivor
        (all_layers / single_layer); federated instead aborts the chapter
        via ``_ShardDropped``.
        """
        rc, plan = self.resilience, self._fault_plan
        if plan is not None and node not in self._dead:
            d = plan.delay_s(kind, layer, chapter, node)
            if d > 0:
                time.sleep(d)
        attempt = 0
        while True:
            try:
                if (plan is not None and node not in self._dead
                        and plan.should_crash(kind, layer, chapter, node)):
                    raise faults_lib.InjectedFault(
                        f"injected crash: {kind}(layer={layer}, "
                        f"chapter={chapter}) on node {node}")
                return body()
            except faults_lib.InjectedFault:
                t0 = time.perf_counter()
                if attempt < rc.max_retries:
                    time.sleep(rc.backoff_base_s
                               * rc.backoff_factor ** attempt)
                    attempt += 1
                    self._rstats["retries"] += 1
                    if self._tracer.enabled:
                        self._tracer.event(
                            "resilience:retry", kind=kind, layer=layer,
                            chapter=chapter, node=node, attempt=attempt)
                    self._rtime("recovery_time_s",
                                time.perf_counter() - t0)
                    continue
                self._declare_dead(node)
                self._rtime("recovery_time_s", time.perf_counter() - t0)
                if self.schedule == "federated":
                    raise _ShardDropped(node) from None

    def _declare_dead(self, node):
        """Retry budget exhausted: graceful degradation.

        all_layers / single_layer: remap the LOGICAL node to the first
        surviving node's device and stream (after everything the dead
        node enqueued) and re-place its constants; the DAG's node
        assignments are untouched, so the same tasks run the same math,
        still bit-exact. federated: no remap, the dead node's shard stops
        contributing.
        """
        self._dead.add(node)
        self._rstats["dead_nodes"].append(node)
        if self._tracer.enabled:
            self._tracer.event("resilience:dead_node", node=node,
                               schedule=self.schedule)
        if self.schedule == "federated":
            self._rstats["shards_dropped"] += 1
            return
        live = [n for n in range(self.num_nodes) if n not in self._dead]
        if not live:
            raise RuntimeError("resilience: every node is dead")
        old_dev = self._nodes.devices[node]
        self._nodes.remap(node, live[0])
        new_dev = self._nodes.devices[node]
        if new_dev != old_dev:
            with self._nodes.on(node):
                self._const[node] = {
                    k: None if v is None else v.to(new_dev)
                    for k, v in self._const[node].items()}
        self._handoff.drop_node_slots(node)
        self._const_dirty = True
        self._rstats["reassignments"] += 1

    def _maybe_kill(self, chapter, phase):
        plan = self._fault_plan
        if plan is not None and plan.kill_now(chapter, phase):
            # a HARD kill (no cleanup, no atexit), so the kill-then-resume
            # tests exercise real crash recovery; the pre-kill checkpoint
            # (phase="post") is already on disk
            self._nodes.sync()
            if self._tracer.enabled:
                self._tracer.event("resilience:kill", chapter=chapter,
                                   phase=phase)
            print(f"[pff_exec] injected kill at chapter {chapter} "
                  f"({phase})", flush=True)
            sys.stderr.flush()
            os._exit(faults_lib.KILL_EXIT)

    # ---- chapter-granular checkpoint / resume ----------------------------
    def _ckpt_has_neg(self):
        """Published negatives are part of the recovery line only for
        score-needing strategies; key-only ones regenerate from the key."""
        return self.has_neg and self.neg.needs_scores

    def _ckpt_template(self):
        """Restore template derived purely from the config (values are
        placeholders: only structure, shapes, dtypes and the device
        count), so a resumed process rebuilds it without the manifest."""
        cfg, dev = self.cfg, self._nodes.devices[0]
        params = ff_mlp.init(cfg, torch.Generator().manual_seed(0), dev)
        opt = ff_mlp.opt_init(params)
        template = {"states": [self.good.get_state(params, opt, k)
                               for k in range(self.n_layers)],
                    "head": (params["head"], opt["head"])}
        if self._ckpt_has_neg():
            template["neg"] = torch.empty(tuple(self.task.x_train.shape),
                                          dtype=torch.float32, device=dev)
        return template

    def _write_checkpoint(self, chapter):
        rc = self.resilience
        if rc is None or rc.checkpoint_dir is None:
            return
        last = chapter == self.cfg.splits - 1
        if (chapter + 1) % rc.checkpoint_every != 0 and not last:
            return
        cfg = self.cfg
        t0 = time.perf_counter()
        # every node's stream drained: the manifest is the closed cut
        # (this device->host drain is the per-chapter overhead)
        self._nodes.sync()
        tree = {"states": list(self._states), "head": self._head}
        if self._ckpt_has_neg():
            tree["neg"] = self._neg[1]
        meta = {"chapter": chapter, "schedule": self.schedule,
                "num_nodes": self.num_nodes, "splits": cfg.splits,
                "seed": cfg.seed, "goodness_fn": cfg.goodness_fn,
                "neg_mode": cfg.neg_mode, "classifier": cfg.classifier,
                "layer_sizes": list(cfg.layer_sizes),
                "neg_chapter": self._neg[0],
                "ver": [int(v) for v in self._ver],
                "head_ver": int(self._head_ver)}
        checkpoint_lib.save(checkpoint_path(rc.checkpoint_dir, chapter),
                            tree, step=chapter, meta=meta,
                            tracer=self._tracer)
        kept = sorted(glob.glob(os.path.join(rc.checkpoint_dir,
                                             "pff_chapter_*.npz")))
        for old in kept[:-rc.keep_last] if rc.keep_last > 0 else []:
            os.remove(old)
        self._rstats["checkpoints_written"] += 1
        self._rtime("checkpoint_time_s", time.perf_counter() - t0)

    def _restore(self, resume_from):
        """Load a chapter manifest (the port's or the reference's) and
        return its completed chapter."""
        path = resume_from
        if os.path.isdir(path):
            path = latest_checkpoint(path)
            if path is None:
                raise FileNotFoundError(
                    f"no pff_chapter_*.npz manifest in {resume_from!r}")
        cfg = self.cfg
        tree, _, meta = checkpoint_lib.restore(
            path, self._ckpt_template(), strict=True, with_meta=True,
            tracer=self._tracer)
        if meta is None:
            raise ValueError(f"{path!r} carries no manifest meta: not a "
                             f"PFF chapter checkpoint")
        want = {"schedule": self.schedule, "num_nodes": self.num_nodes,
                "splits": cfg.splits, "seed": cfg.seed,
                "goodness_fn": cfg.goodness_fn, "neg_mode": cfg.neg_mode,
                "classifier": cfg.classifier,
                "layer_sizes": list(cfg.layer_sizes)}
        for k, v in want.items():
            if meta.get(k) != v:
                raise ValueError(
                    f"checkpoint {path!r} was written by a different run: "
                    f"{k}={meta.get(k)!r} != {v!r}")
        self._states = list(tree["states"])
        self._head = tree["head"]
        if self._ckpt_has_neg():
            self._neg = (int(meta["neg_chapter"]), tree["neg"])
        self._ver = [int(v) for v in meta["ver"]]
        self._head_ver = int(meta["head_ver"])
        return int(meta["chapter"])

    # ---- per-task bodies (each mirrors the sequential trainer) -----------
    def _train_task(self, k, chapter, node, acts, extras, lrs, kc):
        if self.resilience is None:
            return self._train_task_body(k, chapter, node, acts, extras,
                                         lrs, kc)
        out = self._resilient(
            "train", k, chapter, node,
            lambda: self._train_task_body(k, chapter, node, acts, extras,
                                          lrs, kc))
        if k == 0:
            # "mid-chapter" kill point: the chapter's first train task has
            # completed but the chapter has not
            self._maybe_kill(chapter, "mid")
        return out

    def _head_task(self, chapter, node, idx, lrs_head, kc):
        if self.resilience is None:
            return self._head_task_body(chapter, node, idx, lrs_head, kc)
        return self._resilient(
            "head", self.n_layers, chapter, node,
            lambda: self._head_task_body(chapter, node, idx, lrs_head,
                                         kc))

    def _neg_task(self, chapter, node):
        if self.resilience is None:
            return self._neg_task_body(chapter, node)
        return self._resilient(
            "neg_gen", -1, chapter, node,
            lambda: self._neg_task_body(chapter, node))

    def _train_task_body(self, k, chapter, node, acts, extras, lrs, kc):
        """One chapter-train task via the goodness strategy (for §4.4
        goodness its local-head task fused in, as the sequential trainer
        runs it). The incoming state was prefetched onto ``node`` while
        the previous chapter computed (popped: it is trained in place);
        the outgoing state is immediately published toward its DAG
        consumers."""
        t0 = self._tracer.now()
        with self._nodes.on(node):
            if self.resilience is not None:
                # a mid-retry reassignment may have moved the node to
                # another device (same-device no-op)
                dev = self._nodes.devices[node]
                acts = tuple(a.to(dev) for a in acts)
                extras = tuple(e.to(dev) for e in extras)
            state = self._handoff.take(("state", k), node, self._ver[k],
                                       self._states[k], src=self._holder[k],
                                       pop=True)
            state = self.good.train_chapter(
                state, acts, extras, lrs, kc.fold_in(k), cfg=self.cfg,
                epochs=self.C)
            self._states[k] = state
            self._ver[k] = chapter
            self._holder[k] = node
            self._prefetch_state(k, chapter, state, node)
            if self._publish is not None:
                # the bus clones on this stream before parking
                self._publish.publish_layer(k, chapter,
                                            self.good.export([state]))
        self._finish_task(node, "train", k, chapter, t0)
        return state[0]

    def _head_task_body(self, chapter, node, idx, lrs_head, kc):
        const = self._const[node]
        t0 = self._tracer.now()
        with self._nodes.on(node):
            xn_all = (const["x_neutral"] if idx is None
                      else const["x_neutral"][idx])
            # every layer onto the head node (local for all_layers; the
            # prefetched hand-off for single_layer)
            feats = ff_mlp.softmax_feats(
                [self._layer_params(k, node) for k in range(self.n_layers)],
                xn_all, impl=self.impl)
            head, op = self._handoff.take(("head",), node, self._head_ver,
                                          self._head, src=self._head_holder,
                                          pop=True)
            head, op = ff_mlp.train_head_chapter(
                head, op, feats,
                const["y"] if idx is None else const["y"][idx], lrs_head,
                kc.fold_in(77), batch=self.cfg.batch_size, epochs=self.C)
            self._head = (head, op)
            self._head_ver = chapter
            self._head_holder = node
            if self._publish is not None:
                self._publish.publish_head(chapter, head)
            if chapter + 1 < self.cfg.splits:
                nxt = pff_dag.head_node_of(self.schedule, self.num_nodes,
                                           n_layers=self.n_layers,
                                           chapter=chapter + 1)
                if nxt != node:
                    self._handoff.prefetch(("head",), nxt, chapter,
                                           (head, op), src=node)
        self._finish_task(node, "head", self.n_layers, chapter, t0)

    def _neg_task_body(self, chapter, node):
        """Score-needing (AdaptiveNEG) regeneration from the full
        chapter-c model, published for the next chapter."""
        const = self._const[node]
        t0 = self._tracer.now()
        with self._nodes.on(node):
            params = {"layers": [self._layer_params(k, node)
                                 for k in range(self.n_layers)]}
            scores = pff._class_scores_chunked(params, const["x"], self.cfg)
            xn0 = ff_mlp._norm(self.neg.fn(
                self.kneg.fold_in(chapter), self.cfg, params, const["x"],
                const["y"], scores))
            self._neg = (chapter, xn0)
            self._neg_holder = node
            # publish toward every node that trains chapter c+1 while the
            # current chapter's tail is still in flight
            if chapter + 1 < self.cfg.splits:
                for nxt in pff_dag.chapter_train_nodes(
                        self.schedule, self.num_nodes, self.n_layers,
                        chapter=chapter + 1):
                    if nxt != node:
                        self._handoff.prefetch(("neg",), nxt, chapter, xn0,
                                               src=node)
        self._finish_task(node, "neg_gen", -1, chapter, t0)

    # ---- schedule drivers ------------------------------------------------
    def _run_chapter_owned(self, chapter):
        """all_layers / federated / sequential: one node runs the whole
        chapter, computing its own forward features as it trains."""
        node = pff_dag.node_of(self.schedule, self.num_nodes, layer=0,
                               chapter=chapter)
        idx = self._const[node]["idx"]
        lrs, lrs_head = self._lrs(chapter)
        kc = self.key.fold_in(chapter)
        acts, extras = self._chapter_inputs(chapter, node)
        for k in range(self.n_layers):
            lp = self._train_task(k, chapter, node, acts, extras, lrs, kc)
            if k + 1 < self.n_layers:
                # the node's current stream: a reassignment during the
                # train task moved it
                with self._nodes.on(node):
                    dev = self._nodes.devices[node]
                    acts = tuple(self._fwd(lp, a.to(dev)) for a in acts)
        if self.has_head:
            self._head_task(chapter, node, idx, lrs_head, kc)
        if self.has_neg and self.neg.needs_scores:
            self._neg_task(chapter, node)

    def _run_chapter_single_layer(self, chapter):
        """single_layer: node k owns layer k and re-runs the forward pass
        of layers < k over the train set (Algorithm 1 lines 3-5). Weight
        hand-off: node k pulls layers 0..k-1's chapter-c weights."""
        lrs, lrs_head = self._lrs(chapter)
        kc = self.key.fold_in(chapter)
        for k in range(self.n_layers):
            node = pff_dag.node_of(self.schedule, self.num_nodes,
                                   layer=k, chapter=chapter)
            acts, extras = self._chapter_inputs(chapter, node)
            with self._nodes.on(node):
                for j in range(k):       # Algorithm-1 forward recompute
                    w_j = self._layer_params(j, node)
                    acts = tuple(self._fwd(w_j, a) for a in acts)
            self._train_task(k, chapter, node, acts, extras, lrs, kc)
        if self.has_head:
            node = pff_dag.head_node_of(self.schedule, self.num_nodes,
                                        n_layers=self.n_layers,
                                        chapter=chapter)
            self._head_task(chapter, node, None, lrs_head, kc)
        if self.has_neg and self.neg.needs_scores:
            # the LAST node holds the full model freshest: it generates
            # and publishes for everyone (the paper's serialization)
            self._neg_task(chapter,
                           pff_dag.neg_node_of(self.schedule,
                                               self.num_nodes,
                                               chapter=chapter))

    # ---- elastic federated rounds (resilience.membership) ----------------
    def _run_round_elastic(self, r):
        """One elastic Federated-PFF round: every live node trains a COPY
        of the round-start model on its own shard (on its own stream),
        then node 0 replaces the global model with the live results
        averaged by live shard sizes, nodes in sorted order, through
        ``pff.elastic_node_round`` / ``pff.weighted_average_trees``: the
        calls of ``pff.run_elastic_federated``, so the round is
        bit-identical to the sequential reference."""
        rc = self.resilience
        nodes = self._nodes
        live = [n for n in pff._check_membership(rc.membership(r),
                                                 self.num_nodes, r)
                if n not in self._dead]
        if not live:
            self._rstats["chapters_skipped"] += 1
            self._rstats["elastic_rounds"].append(
                {"round": r, "live": [], "weights": []})
            return
        lrs, lrs_head = self._lrs(r)
        kr = self.key.fold_in(r)
        # per-node copies FIRST: each node trains its copy in place
        placed = {node: ([nodes.move(s, self._holder[k], node)
                          for k, s in enumerate(self._states)],
                         nodes.move(self._head, self._head_holder, node))
                  for node in live}
        per_node = {}
        first_done = False
        for node in live:
            const = self._const[node]
            idx = const["idx"]
            acts, extras = self._chapter_inputs(r, node)
            st0, head0 = placed[node]

            def body(node=node, const=const, idx=idx, acts=acts,
                     extras=extras, st0=st0, head0=head0):
                t0 = self._tracer.now()
                with nodes.on(node):
                    out = pff.elastic_node_round(
                        self.good, self.cfg, st0, head0, acts, extras, lrs,
                        lrs_head, kr.fold_in(node), epochs=self.C,
                        impl=self.impl,
                        y=const["y"][idx] if self.has_head else None,
                        x_neutral=(const["x_neutral"][idx]
                                   if self.has_head else None),
                        train_head=self.has_head)
                self._finish_task(node, "round", -1, r, t0)
                return out

            try:
                per_node[node] = self._resilient("round", -1, r, node,
                                                 body)
            except _ShardDropped:
                continue
            if not first_done:
                first_done = True
                self._maybe_kill(r, "mid")
        ok = [n for n in live if n in per_node]
        if not ok:
            self._rstats["chapters_skipped"] += 1
            self._rstats["elastic_rounds"].append(
                {"round": r, "live": [], "weights": []})
            return
        total = float(sum(int(self._const[n]["idx"].shape[0]) for n in ok))
        w = [int(self._const[n]["idx"].shape[0]) / total for n in ok]
        with nodes.on(0):
            self._states = [pff.weighted_average_trees(
                [nodes.move(per_node[n][0][k], n, 0, copy=False)
                 for n in ok], w) for k in range(self.n_layers)]
            self._holder = [0] * self.n_layers
            self._ver = [r] * self.n_layers
            if self.has_head:
                self._head = pff.weighted_average_trees(
                    [nodes.move(per_node[n][1], n, 0, copy=False)
                     for n in ok], w)
                self._head_holder = 0
                self._head_ver = r
            self._publish_snapshot(r)
        self._rstats["elastic_rounds"].append(
            {"round": r, "live": ok, "weights": w})

    # ---- entry point -----------------------------------------------------
    def _fresh_rstats(self):
        return {"retries": 0, "reassignments": 0, "dead_nodes": [],
                "checkpoints_written": 0, "checkpoint_time_s": 0.0,
                "restore_time_s": 0.0, "resumed_from_chapter": None,
                "recovery_time_s": 0.0, "faults_injected": {},
                "shards_dropped": 0, "chapters_skipped": 0,
                "elastic_rounds": None}

    def _publish_snapshot(self, version: int):
        """Publish the CURRENT full model (every layer + head) at one
        version: the initial snapshot, a restored recovery line, and the
        elastic federated aggregate."""
        if self._publish is None:
            return
        for k, state in enumerate(self._states):
            self._publish.publish_layer(k, version,
                                        self.good.export([state]))
        if self.has_head:
            self._publish.publish_head(version, self._head[0])

    def _federated_chapter_with_rollback(self, chapter):
        """A federated chapter under a fault plan: a mid-chapter death
        must not leave a half-trained chapter, so the recovery line is
        snapshotted (copies on each holder's stream: the chapter trains
        the live trees in place) and restored on ``_ShardDropped``."""
        nodes = self._nodes
        snap = ([nodes.move(s, h, h)
                 for s, h in zip(self._states, self._holder)],
                nodes.move(self._head, self._head_holder,
                           self._head_holder))
        snap_meta = (list(self._ver), self._head_ver, self._neg,
                     list(self._holder), self._head_holder,
                     self._neg_holder)
        try:
            self._run_chapter_owned(chapter)
        except _ShardDropped:
            self._states, self._head = list(snap[0]), snap[1]
            (ver, self._head_ver, self._neg, holder, self._head_holder,
             self._neg_holder) = snap_meta
            self._ver, self._holder = list(ver), list(holder)
            self._rstats["chapters_skipped"] += 1

    def run(self, *, profile: bool = False,
            resume_from: Optional[str] = None,
            publish=None, trace=None, chapters: Optional[int] = None,
            carry: bool = False, evaluate: bool = True,
            after_chapter=None) -> ExecResult:
        """Executes the schedule once. ``profile=True`` synchronizes after
        every task to collect per-task ``TaskRecord``s (destroys the
        overlap, so use a separate run for makespan).

        chapters: how many chapters this call runs (default: every one
        left of ``cfg.splits``; a count may run past it, at the
        cooldown's zero rate). carry: continue from the trained state
        the last run left, layers, Adam state, head and published
        negatives, at the chapter after its last (a first run starts
        from the initial params as without it); the chapters run as the
        schedule's one run would run them, bit for bit. evaluate: score
        the test split (``ExecResult.test_acc``; None without).
        after_chapter: called with each chapter's number once its tasks
        are dispatched, before the next chapter's; ``state(copy=True)``
        there keeps that chapter's state while the run goes on.

        trace: an ``obs.trace.Tracer`` (or True for a fresh one): one
        ``task:<kind>`` span per DAG task plus hand-off / retry /
        checkpoint events and a closing ``run`` span. With
        ``block_tasks`` (the default) the spans are device time and
        ``ExecResult.records`` / ``node_busy`` come from them. Use a
        FRESH tracer per run.

        resume_from: a chapter manifest written by a previous run (or its
        directory: the newest manifest is used); training replays the DAG
        from the chapter after it, bit-exactly.

        publish: a ``serve.bus.WeightBus`` (anything with
        ``publish_layer``/``publish_head``): every chapter-train task
        pushes its freshly trained layer the moment it completes, plus a
        snapshot before the first chapter. The bus copies what it parks,
        so the weight stream is bit-exact, publish or not.
        """
        with torch.no_grad():
            return self._run(profile, resume_from, publish, trace,
                             chapters, carry, evaluate, after_chapter)

    def state(self, copy: bool = False):
        """The trained state the last run left: ``{"params", "opt"}``
        (the layers' and the head's, on their holders' devices, views),
        ``"neg"`` (the negatives published for the next chapter, or
        None) and ``"next_chapter"``. copy: each tree copied on the
        stream of the node that last wrote it, ordered after that write
        and before the node's next task; read the copies once the run
        has returned."""
        def get(tree, node):
            if not copy:
                return tree
            with self._nodes.on(node):
                return tree_map(lambda t: t.clone(), tree)

        states = [get(st, self._holder[k])
                  for k, st in enumerate(self._states)]
        head = get(self._head, self._head_holder)
        return {"params": {**self.good.export(states), "head": head[0]},
                "opt": {"layers": [st[1] for st in states],
                        "head": head[1]},
                "neg": get(self._neg[1], self._neg_holder),
                "next_chapter": self._next}

    def _fresh_state(self, dev0):
        """The run's initial trees, versions and holders: node 0 holds
        the initial params (``params0``, copied, or drawn from the
        key)."""
        cfg = self.cfg
        params = (ff_mlp.init(cfg, self.key, dev0) if self.params0 is None
                  else tree_map(lambda t: t.to(dev0, copy=True),
                                self.params0))
        opt = ff_mlp.opt_init(params)
        self._neg: Tuple[int, object] = (-1, None)
        self._ver = [-1] * self.n_layers       # chapter of last train(k)
        self._head_ver = -1
        # the node whose stream last wrote each tree (node 0 holds the
        # initial and restored ones)
        self._holder = [0] * self.n_layers
        self._head_holder = 0
        self._neg_holder = 0
        self._states = [self.good.get_state(params, opt, k)
                        for k in range(self.n_layers)]
        self._head = (params["head"], opt["head"])

    def _run(self, profile, resume_from, publish, trace, chapters=None,
             carry=False, evaluate=True, after_chapter=None):
        cfg = self.cfg
        rc = self.resilience
        plan = self._fault_plan
        if plan is not None:
            plan.reset()
        tracer = obs_trace.as_tracer(trace)
        if profile and not tracer.enabled:
            tracer = obs_trace.Tracer()     # profile rides the tracer
        self._tracer = tracer
        # timeline mode: synchronize per task so span durations are
        # device time (destroys overlap)
        self._block = profile or (tracer.enabled and tracer.block_tasks)
        timeline = tracer.enabled and self._block
        span0 = tracer.span_count()
        nodes = self._nodes
        nodes.reset()
        if self._const_dirty:
            self._setup_constants()
            self._const_dirty = False
        self._dead: set = set()
        self._rstats = self._fresh_rstats()
        elastic = rc is not None and rc.membership is not None
        if elastic:
            self._rstats["elastic_rounds"] = []
        dev0 = nodes.devices[0]
        carried = carry and self._next is not None
        if not carried:
            self._fresh_state(dev0)
        self._publish = publish
        self._handoff = _Handoff(
            nodes, self.overlap,
            fault_cb=plan.handoff_action if plan is not None else None,
            tracer=tracer)

        t_start = time.perf_counter()
        t_trace0 = tracer.now()
        start_chapter = self._next if carried else 0
        if resume_from is not None:
            t0 = time.perf_counter()
            done = self._restore(resume_from)
            start_chapter = done + 1
            # sanity: the resume point must be a closed cut of the DAG
            pff_dag.replay_frontier(
                self.n_layers, cfg.splits, start_chapter,
                has_head=self.has_head, has_neg=self._ckpt_has_neg(),
                strict_neg=self._ckpt_has_neg())
            self._rstats["resumed_from_chapter"] = done
            self._rtime("restore_time_s", time.perf_counter() - t0)
        if not carried:
            # the trees made on the current stream: every node may read
            # them (carried ones were made before the last run's sync)
            nodes.share([self._states, self._head, self._neg[1]])
        with nodes.on(0):
            self._publish_snapshot(min([self._head_ver] + self._ver
                                       if self.has_head else self._ver))
        stop = cfg.splits if chapters is None else start_chapter + chapters
        for chapter in range(start_chapter, stop):
            if elastic:
                self._run_round_elastic(chapter)
            elif self.schedule == "single_layer":
                self._run_chapter_single_layer(chapter)
            elif (self.schedule == "federated" and self._dead
                  and pff_dag.node_of(self.schedule, self.num_nodes,
                                      layer=0, chapter=chapter)
                  in self._dead):
                # the owning node died in an earlier chapter: its shard
                # no longer contributes (the model rests this round)
                self._rstats["chapters_skipped"] += 1
            elif self.schedule == "federated" and plan is not None:
                self._federated_chapter_with_rollback(chapter)
            else:
                self._run_chapter_owned(chapter)
            self._write_checkpoint(chapter)
            if rc is not None:
                self._maybe_kill(chapter, "post")
            if after_chapter is not None:
                after_chapter(chapter)
        nodes.sync()
        self._next = stop
        makespan = time.perf_counter() - t_start
        if tracer.enabled:
            # the closing run span carries the DAG shape so obs.analyze
            # can rebuild the pff_dag dependency structure from the trace
            strict = self.has_neg and self.neg.needs_scores
            tracer.add_span(
                "run", t_trace0, schedule=self.schedule,
                num_nodes=self.num_nodes, splits=cfg.splits,
                n_layers=self.n_layers, has_head=self.has_head,
                has_neg=strict, strict_neg=strict,
                start_chapter=start_chapter, overlap=self.overlap,
                blocked=self._block, makespan_s=makespan)

        # the result on the current stream, independent of the nodes'
        final = tree_map(lambda t: t.to(dev0, copy=True),
                         {**self.good.export(self._states),
                          "head": self._head[0]})
        acc = (ff_mlp.accuracy(final, self.task.x_test, self.task.y_test,
                               cfg.num_classes, self.good.eval_mode(cfg),
                               impl=self.impl) if evaluate else None)
        records = node_busy = None
        if timeline:
            records, node_busy = _records_from_spans(tracer, span0,
                                                     self.num_nodes)
        res_stats = None
        if rc is not None or resume_from is not None:
            res_stats = dict(self._rstats)
            res_stats["faults_injected"] = (dict(plan.fired)
                                            if plan is not None else {})
        self._block = False
        return ExecResult(final, self.schedule, self.num_nodes, makespan,
                          acc, records, node_busy,
                          dict(self._handoff.stats), res_stats,
                          tracer if tracer.enabled else None)


def params_bit_equal(a, b, *, with_head=False, with_local_heads=False):
    """True iff two FF-MLP params trees carry BIT-IDENTICAL layer (and
    optionally head / §4.4 local-head) weights: the executor's
    correctness oracle."""
    def leaves_equal(pa, pb):
        return all(pa[n].dtype == pb[n].dtype
                   and torch.equal(pa[n], pb[n].to(pa[n].device))
                   for n in ("w", "b"))
    if len(a["layers"]) != len(b["layers"]):
        return False
    ok = all(leaves_equal(pa, pb)
             for pa, pb in zip(a["layers"], b["layers"]))
    if with_head:
        ok = ok and leaves_equal(a["head"], b["head"])
    if with_local_heads:
        ok = (ok and len(a["local_heads"]) == len(b["local_heads"])
              and all(leaves_equal(pa, pb) for pa, pb in
                      zip(a["local_heads"], b["local_heads"])))
    return ok


class LMExecutor(_NodeExecutor):
    """Runs the LM chapter schedule (``core.pff_lm``) for real on
    ``num_nodes`` nodes: the transformer sibling of ``PFFExecutor``,
    sharing its nodes (N CUDA streams of one card, or N x ``cpu``), its
    ``_Handoff`` slots, its tracer conventions and its oracle.

    Bit-exactness: every task makes exactly the calls of the sequential
    ``pff_lm.train_chapters``: the same ``make_block_task`` /
    ``make_head_task`` steps (the sequential trainer's ``make_block_step``
    / ``make_head_step`` wrap them), the same ``chapter_batches`` stream
    (regenerated on each node: training data never crosses the
    hand-off), the same global step numbers and keys. A task is handed
    only what it reads, never a full (params, opt) tree: the embedding
    table, the frozen prefix blocks' params, its own block's (params, m,
    v) state, or the head's.

    Hand-off per train(k, c): the block's full state goes to the node
    that trains it in chapter c+1 (``("state", k)``), its params to the
    forward-recompute and head consumers within chapter c
    (``("params", k)``), as ``pff_dag.handoff_targets`` names them. The
    head task publishes its state toward the next chapter's head node
    (``("head",)``) and, with tied embeddings, its params toward every
    chapter-(c+1) train node (``("headp",)``): the DAG's head_feedback
    edge (every block task reads the post-head embedding table). The
    trees are updated in place, so a tree crossing nodes is copied on the
    producer's stream (``_Nodes.move``); a node that holds the tree
    copies nothing.

    params: the initial params (copied per run); default
    ``pff_lm.init_params(cfg, seed, devices[0])``. key_fn / impl: as
    ``pff_lm.train_chapters`` takes them.
    """

    def __init__(self, cfg, source, schedule: str, num_nodes: int, *,
                 chapters: int, steps_per_chapter: int, batch: int = 8,
                 lr: float = 1e-3, head_lr: Optional[float] = None,
                 seed: int = 0, devices=None, overlap: bool = True,
                 device=None, params=None, key_fn=TorchKey,
                 impl: str = "auto"):
        if schedule not in ("sequential", "single_layer", "all_layers"):
            raise ValueError(
                f"LM chapter executor supports sequential / single_layer"
                f" / all_layers; got {schedule!r} (federated LM shards "
                f"are ROADMAP work)")
        if schedule == "sequential" and num_nodes != 1:
            raise ValueError("sequential means num_nodes=1")
        if len(cfg.groups) != 1:
            raise ValueError("chapter schedule needs a uniform stack "
                             f"(one group); got {len(cfg.groups)}")
        super().__init__(_node_devices(num_nodes, devices, device))
        self.cfg = cfg
        self.source = source
        self.schedule = schedule
        self.num_nodes = num_nodes
        self.chapters = chapters
        self.steps_per_chapter = steps_per_chapter
        self.batch = batch
        self.overlap = overlap
        self.seed = seed
        self.params0 = params
        self.n_layers = cfg.groups[0][1]
        self.tied = bool(cfg.tie_embeddings)
        self._head_names = pff_lm.head_param_names(cfg)
        self._step = pff_lm.make_block_task(cfg, lr=lr, seed=seed,
                                            key_fn=key_fn, impl=impl)
        self._head_step = pff_lm.make_head_task(
            cfg, head_lr=lr if head_lr is None else head_lr, impl=impl)

    def _data(self, node, chapter, block):
        return pff_lm.chapter_batches(
            self.source, batch=self.batch, steps=self.steps_per_chapter,
            device=self._nodes.devices[node])(chapter, block)

    def _params_on(self, j, node, chapter):
        """Block j's chapter-``chapter`` params, for reading on ``node``."""
        if self._ver[j] != chapter:
            raise RuntimeError(f"block {j} is at chapter {self._ver[j]}, "
                               f"not {chapter}: the DAG order broke")
        return self._handoff.take(("params", j), node, chapter,
                                  self._blk[j][0], src=self._holder[j])

    def _train_task(self, k, chapter, node):
        """One per-block chapter task: the sequential trainer's
        ``steps_per_chapter`` block steps with its global step numbers,
        then the state published toward the DAG consumers."""
        t0 = self._tracer.now()
        with self._nodes.on(node):
            prefix = [self._params_on(j, node, chapter) for j in range(k)]
            state = self._handoff.take(("state", k), node, self._ver[k],
                                       self._blk[k], src=self._holder[k],
                                       pop=True)
            if self.tied:
                # head_feedback edge: the table this task reads is the
                # one head(chapter - 1) produced
                embed = self._handoff.take(
                    ("headp",), node, self._head_ver, self._head[0],
                    src=self._head_holder)["embed"]
            else:
                embed = self._embed
            base = (chapter * self.n_layers + k) * self.steps_per_chapter
            for s, batch in enumerate(self._data(node, chapter, k)):
                self._step(embed, prefix, state, batch, k, base + s + 1)
            self._blk[k] = state
            self._ver[k] = chapter
            self._holder[k] = node
            nxt, param_nodes = pff_dag.handoff_targets(
                self.schedule, self.num_nodes, n_layers=self.n_layers,
                splits=self.chapters, layer=k, chapter=chapter,
                has_head=True, has_neg=False)
            if nxt is not None:
                self._handoff.prefetch(("state", k), nxt, chapter, state,
                                       src=node)
            for pn in param_nodes:
                self._handoff.prefetch(("params", k), pn, chapter,
                                       state[0], src=node)
        self._finish_task(node, "train", k, chapter, t0)

    def _head_task(self, chapter, node):
        """The per-chapter softmax-head task: frozen forward through every
        chapter-c block, CE on the head subset, head state published
        toward chapter c+1."""
        t0 = self._tracer.now()
        with self._nodes.on(node):
            units = [self._params_on(j, node, chapter)
                     for j in range(self.n_layers)]
            head = self._handoff.take(("head",), node, self._head_ver,
                                      self._head, src=self._head_holder,
                                      pop=True)
            embed = head[0]["embed"] if self.tied else self._embed
            base = chapter * self.steps_per_chapter
            for s, batch in enumerate(self._data(node, chapter,
                                                 self.n_layers)):
                self._head_step(embed, units, head, batch, base + s + 1)
            self._head = head
            self._head_ver = chapter
            self._head_holder = node
            if chapter + 1 < self.chapters:
                nh = pff_dag.head_node_of(self.schedule, self.num_nodes,
                                          n_layers=self.n_layers,
                                          chapter=chapter + 1)
                if nh != node:
                    self._handoff.prefetch(("head",), nh, chapter, head,
                                           src=node)
                if self.tied:
                    for tn in pff_dag.chapter_train_nodes(
                            self.schedule, self.num_nodes, self.n_layers,
                            chapter=chapter + 1):
                        if tn != node:
                            self._handoff.prefetch(("headp",), tn, chapter,
                                                   head[0], src=node)
        self._finish_task(node, "head", self.n_layers, chapter, t0)

    def run(self, *, profile: bool = False, trace=None) -> ExecResult:
        """Executes the LM chapter schedule once. Same tracer/profile
        semantics as ``PFFExecutor.run``; ``test_acc`` is None (LM
        quality is eval CE, scored by ``api.fit`` for both backends)."""
        with torch.no_grad():
            return self._run(profile, trace)

    def _run(self, profile, trace):
        cfg = self.cfg
        tracer = obs_trace.as_tracer(trace)
        if profile and not tracer.enabled:
            tracer = obs_trace.Tracer()
        self._tracer = tracer
        self._block = profile or (tracer.enabled and tracer.block_tasks)
        timeline = tracer.enabled and self._block
        span0 = tracer.span_count()
        nodes = self._nodes
        nodes.reset()
        dev0 = nodes.devices[0]
        t_start = time.perf_counter()
        t_trace0 = tracer.now()
        params = (pff_lm.init_params(cfg, self.seed, dev0)
                  if self.params0 is None
                  else tree_map(lambda t: t.to(dev0, copy=True),
                                self.params0))
        opt = optim.adam_init(params)
        # the canonical state partition: per-block unit views + the head
        self._blk = list(zip(*(pff_lm.block_units(t, self.n_layers)
                               for t in (params, opt["m"], opt["v"]))))
        self._head = tuple({n: t[n] for n in self._head_names}
                           for t in (params, opt["m"], opt["v"]))
        self._embed = params["embed"]
        self._ver = [-1] * self.n_layers
        self._head_ver = -1
        self._holder = [0] * self.n_layers
        self._head_holder = 0
        self._handoff = _Handoff(nodes, self.overlap, tracer=tracer)
        # the trees made on the current stream: every node may read them
        nodes.share([self._blk, self._head, self._embed])
        for c in range(self.chapters):
            for k in range(self.n_layers):
                self._train_task(k, c, pff_dag.node_of(
                    self.schedule, self.num_nodes, layer=k, chapter=c))
            self._head_task(c, pff_dag.head_node_of(
                self.schedule, self.num_nodes, n_layers=self.n_layers,
                chapter=c))
        nodes.sync()
        makespan = time.perf_counter() - t_start
        if tracer.enabled:
            tracer.add_span(
                "run", t_trace0, schedule=self.schedule,
                num_nodes=self.num_nodes, splits=self.chapters,
                n_layers=self.n_layers, has_head=True, has_neg=False,
                strict_neg=False, head_feedback=self.tied,
                start_chapter=0, overlap=self.overlap,
                blocked=self._block, makespan_s=makespan)
        # the canonical full params tree on the current stream: exactly
        # the tree the sequential trainer returns
        final = {}
        for name in params:
            if name == "groups":
                final[name] = (tree_stack([
                    tree_map(lambda t: t.to(dev0), blk[0])
                    for blk in self._blk]),)
            elif name in self._head_names:
                final[name] = self._head[0][name].to(dev0, copy=True)
            else:
                final[name] = params[name].clone()
        records = node_busy = None
        if timeline:
            records, node_busy = _records_from_spans(tracer, span0,
                                                     self.num_nodes)
        self._block = False
        return ExecResult(final, self.schedule, self.num_nodes, makespan,
                          None, records, node_busy,
                          dict(self._handoff.stats), None,
                          tracer if tracer.enabled else None)


# ---------------------------------------------------------------------------
# Self-test CLI: python -m repro_torch.core.pff_exec [--device cpu]
# ---------------------------------------------------------------------------

def _case_setup(splits, n_train, neg_mode, classifier, goodness_fn):
    """The (cfg, task) every selftest case trains (the reference's
    ``_case_setup``), shared by the bit-exactness matrix and the
    resilience cases."""
    from repro_torch.configs.ff_mlp import FFMLPConfig

    task = data_lib.mnist_like(n_train=n_train, n_test=200)
    cfg = FFMLPConfig(layer_sizes=(784, 128, 128), epochs=splits * 2,
                      splits=splits, neg_mode=neg_mode,
                      classifier=classifier, goodness_fn=goodness_fn,
                      batch_size=64, seed=0)
    return cfg, task


def _diverged(ref, res, *, with_head, with_local_heads, label):
    """Failure strings naming each leaf of ``res`` that differs from
    ``ref`` and by how much."""
    named = [(f"layer {k}", a, b) for k, (a, b) in
             enumerate(zip(ref["layers"], res["layers"]))]
    if with_head:
        named.append(("head", ref["head"], res["head"]))
    if with_local_heads:
        named += [(f"local_head {k}", a, b) for k, (a, b) in
                  enumerate(zip(ref["local_heads"], res["local_heads"]))]
    out = []
    for what, pa, pb in named:
        for name in ("w", "b"):
            if not torch.equal(pa[name], pb[name].to(pa[name].device)):
                err = float((pa[name] - pb[name].to(pa[name].device))
                            .abs().max())
                out.append(f"{label}: {what} {name} diverged, "
                           f"max|diff|={err:.3e}")
    return out


def _check_case(schedule, nodes, splits, n_train, neg_mode, classifier,
                goodness_fn="sumsq", *, check_sim_bound=False,
                check_overlap_ab=False, device=None):
    """Trains one config both ways, through ``api.fit``, and returns a
    list of failure strings (empty = the executor reproduced the
    sequential or federated trainer's weight stream bit-exactly).

    check_overlap_ab: also runs the executor with the double-buffered
    hand-off DISABLED and requires both weight streams to be
    bit-identical, the overlap run to hit its prefetched slots and the
    other to issue none."""
    from repro_torch import api

    cfg, task = _case_setup(splits, n_train, neg_mode, classifier,
                            goodness_fn)
    if schedule == "federated":
        ref = api.fit(cfg, task, backend="federated", num_nodes=nodes,
                      device=device)
    else:
        ref = api.fit(cfg, task, backend="sequential", device=device)
    res = api.fit(cfg, task, backend="executor", schedule=schedule,
                  num_nodes=nodes, device=device)
    with_head = classifier == "softmax"
    perf_opt = goodness_fn == "perf_opt"
    failures = []
    if check_overlap_ab:
        off = api.fit(cfg, task, backend="executor", schedule=schedule,
                      num_nodes=nodes, overlap=False, device=device)
        stats_on, stats_off = res.raw.handoff, off.raw.handoff
        if not params_bit_equal(off.params, res.params, with_head=with_head,
                                with_local_heads=perf_opt):
            failures.append(f"{schedule}: overlap-on vs overlap-off "
                            "weight streams diverged")
        if stats_off["prefetch_issued"] != 0:
            failures.append(f"{schedule}: overlap=False still issued "
                            f"{stats_off['prefetch_issued']} prefetches")
        if nodes > 1 and stats_on["prefetch_hits"] == 0:
            failures.append(f"{schedule}: overlap=True never hit a "
                            f"prefetched slot ({stats_on})")
        print(f"  overlap A/B {schedule}: on={stats_on} off={stats_off}")
    if not params_bit_equal(ref.params, res.params, with_head=with_head,
                            with_local_heads=perf_opt):
        failures += _diverged(ref.params, res.params, with_head=with_head,
                              with_local_heads=perf_opt, label=schedule)
    sim_note = ""
    if check_sim_bound:
        # sanity bound, deliberately loose: a real run can never beat the
        # simulator's perfect-overlap replay of the same task times by 4x
        sim = pff.simulate_schedule(ref.records, schedule, nodes)
        sim_note = f" sim={sim.makespan:.2f}s"
        if res.makespan < 0.25 * sim.makespan:
            failures.append(
                f"{schedule}: measured makespan {res.makespan:.3f}s "
                f"implausibly beats the simulator's perfect-overlap "
                f"prediction {sim.makespan:.3f}s by more than 4x")
    print(f"device={res.device} schedule={schedule} nodes={nodes} "
          f"neg={neg_mode} cls={classifier} goodness={goodness_fn}: "
          f"exec acc={res.test_acc:.4f} seq acc={ref.test_acc:.4f} "
          f"makespan={res.makespan:.2f}s{sim_note} -> "
          + ("FAIL" if failures else "bit-exact"))
    return failures


# (schedule, nodes, splits, n_train, neg_mode, classifier[, goodness_fn]):
# the reference's matrix. n_train=520: 520 % 64 != 0, so the tail-batch
# path is always exercised; federated shards of 130 hit another tail.
# The perf_opt rows check the §4.4 path end to end, including the
# single_layer forward recompute. The _AB_CASES rows double as the
# double-buffering A/B gate: row 1 (all_layers adaptive softmax) routes
# published negatives, the softmax head and full layer states through
# the next-chapter prefetch; row 3 (single_layer random) the params-only
# forward-recompute fan-out; row 6 (single_layer adaptive softmax) the
# single_layer head-node and published-negatives fan-out.
_MATRIX = (
    ("all_layers", 4, 4, 520, "random", "goodness"),
    ("all_layers", 4, 3, 520, "adaptive", "softmax"),
    ("federated", 4, 4, 520, "random", "goodness"),
    ("single_layer", 2, 3, 520, "random", "goodness"),
    ("all_layers", 4, 3, 520, "random", "goodness", "perf_opt"),
    ("single_layer", 2, 3, 520, "random", "goodness", "perf_opt"),
    ("single_layer", 2, 3, 520, "adaptive", "softmax"),
)
# rows that additionally run the overlap-on vs overlap-off comparison
_AB_CASES = (1, 3, 6)


def _lm_case_setup(n_blocks, tied, *, seq_len=16):
    """The (cfg, source) every LM selftest case trains (the reference's
    ``_lm_case_setup``): a small qwen2-0.5b-shaped stack over the
    real-text BPE source."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2-0.5b").reduced()
    cfg = dataclasses.replace(cfg, num_layers=n_blocks,
                              groups=((("attn",), n_blocks),),
                              tie_embeddings=tied)
    return cfg, data_lib.text_source(vocab=cfg.vocab, seq_len=seq_len,
                                     seed=0)


def _lm_check_case(schedule, nodes, n_blocks, chapters, steps, tied, *,
                   check_overlap_ab=False, device=None):
    """Trains one LM config both ways, through ``api.fit``, and returns
    failure strings (empty = the executor reproduced the sequential
    ``train_chapters`` weight stream bit-exactly, and its eval CE)."""
    from repro_torch import api

    cfg, source = _lm_case_setup(n_blocks, tied)
    kw = dict(chapters=chapters, steps_per_chapter=steps, batch=4, lr=1e-3,
              device=device)
    ref = api.fit(cfg, source, backend="sequential", **kw)
    res = api.fit(cfg, source, backend="executor", schedule=schedule,
                  num_nodes=nodes, **kw)
    failures = []
    if not pff_lm.lm_params_bit_equal(ref.params, res.params):
        failures.append(f"lm {schedule}: executor weight stream diverged "
                        f"from sequential train_chapters (tied={tied})")
    if res.eval_ce != ref.eval_ce:
        failures.append(f"lm {schedule}: eval CE {res.eval_ce} != "
                        f"{ref.eval_ce}")
    if check_overlap_ab:
        off = api.fit(cfg, source, backend="executor", schedule=schedule,
                      num_nodes=nodes, overlap=False, **kw)
        stats_on, stats_off = res.raw.handoff, off.raw.handoff
        if not pff_lm.lm_params_bit_equal(off.params, res.params):
            failures.append(f"lm {schedule}: overlap-on vs overlap-off "
                            "weight streams diverged")
        if stats_off["prefetch_issued"] != 0:
            failures.append(f"lm {schedule}: overlap=False still issued "
                            f"{stats_off['prefetch_issued']} prefetches")
        if nodes > 1 and stats_on["prefetch_hits"] == 0:
            failures.append(f"lm {schedule}: overlap=True never hit a "
                            f"prefetched slot ({stats_on})")
        print(f"  lm overlap A/B {schedule}: on={stats_on} off={stats_off}")
    print(f"device={res.device} lm schedule={schedule} nodes={nodes} "
          f"blocks={n_blocks} tied={tied}: exec ce={res.eval_ce:.4f} seq "
          f"ce={ref.eval_ce:.4f} makespan={res.makespan:.2f}s -> "
          + ("FAIL" if failures else "bit-exact"))
    return failures


# (schedule, nodes, n_blocks, chapters, steps_per_chapter, tied): the
# reference's LM matrix. Rows 0/1: both paper schedules on 4 nodes with
# tied embeddings (the head_feedback edge: every block task must see the
# post-head embedding table), with the overlap A/B gate. Row 2: the
# untied head (lm_head) and nodes not dividing the block count, so the
# single_layer round-robin wraps.
_LM_MATRIX = (
    ("all_layers", 4, 4, 3, 2, True),
    ("single_layer", 4, 4, 3, 2, True),
    ("single_layer", 2, 3, 2, 2, False),
)
_LM_AB_CASES = (0, 1)


def _resilience_case(args):
    """One resilience run from the CLI: inject ``--fault-plan``, write
    chapter manifests into ``--checkpoint-dir``, resume from
    ``--resume-from``, and gate the surviving weight stream against the
    fault-free reference with ``params_bit_equal`` wherever the policy
    promises bit-exactness (everywhere except federated shard drops). A
    ``kill_*`` plan exits the process with ``faults.KILL_EXIT`` before
    any comparison; the caller re-invokes with ``--resume-from``."""
    from repro_torch import api

    cfg, task = _case_setup(args.splits, args.n_train, args.neg_mode,
                            args.classifier, args.goodness_fn)
    plan = None
    if args.fault_plan:
        plan = faults_lib.named_plan(
            args.fault_plan, splits=cfg.splits,
            n_layers=len(cfg.layer_sizes) - 1, num_nodes=args.nodes)
    rc = faults_lib.ResilienceConfig(checkpoint_dir=args.checkpoint_dir,
                                     fault_plan=plan)
    res = api.fit(cfg, task, backend="executor", schedule=args.schedule,
                  num_nodes=args.nodes, resilience=rc,
                  resume_from=args.resume_from, device=args.device)
    stats = res.raw.resilience
    print(f"resilience {args.schedule} nodes={args.nodes} "
          f"device={res.device} plan={args.fault_plan or '-'} "
          f"resume={'yes' if args.resume_from else 'no'}: "
          f"acc={res.test_acc:.4f} retries={stats['retries']} "
          f"reassignments={stats['reassignments']} "
          f"dead={stats['dead_nodes']} "
          f"faults={stats['faults_injected']} "
          f"checkpoint_s={stats['checkpoint_time_s']:.4f} "
          f"restore_s={stats['restore_time_s']:.4f}")
    if stats["shards_dropped"] or stats["chapters_skipped"]:
        print("  federated shard-drop degradation: bit-exactness gate "
              "skipped (weighted rounds lost a shard by design)")
        return []
    if args.schedule == "federated":
        ref = api.fit(cfg, task, backend="federated", num_nodes=args.nodes,
                      device=args.device)
    else:
        ref = api.fit(cfg, task, backend="sequential", device=args.device)
    if not params_bit_equal(ref.params, res.params,
                            with_head=args.classifier == "softmax",
                            with_local_heads=args.goodness_fn
                            == "perf_opt"):
        return [f"{args.schedule}: resilient run diverged from the "
                f"fault-free reference (plan={args.fault_plan})"]
    print("  bit-exact vs fault-free reference")
    return []


def _selftest(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--matrix", action="store_true",
                   help="run the full schedule/neg/classifier matrix in "
                        "one process")
    p.add_argument("--lm-matrix", action="store_true",
                   help="run the LM chapter-schedule bit-exactness matrix "
                        "(LMExecutor vs pff_lm.train_chapters on the "
                        "real-text BPE source)")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--schedule", default="all_layers",
                   choices=list(pff_dag.SCHEDULES))
    p.add_argument("--splits", type=int, default=4)
    p.add_argument("--n-train", type=int, default=1000,
                   help="deliberately NOT divisible by the batch size, "
                        "so the tail-batch path is exercised too")
    p.add_argument("--neg-mode", default="random",
                   choices=list(strategies.negatives.names()))
    p.add_argument("--classifier", default="goodness",
                   choices=list(strategies.classifier.names()))
    p.add_argument("--goodness-fn", default="sumsq",
                   choices=list(strategies.goodness.names()))
    p.add_argument("--fault-plan", default=None,
                   choices=sorted(faults_lib.NAMED_PLANS),
                   help="inject a named deterministic fault plan "
                        "(core.faults.NAMED_PLANS) and gate the surviving "
                        "weight stream")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write chapter-granular manifests here (one "
                        "atomic .npz per completed chapter)")
    p.add_argument("--resume-from", default=None,
                   help="chapter manifest (or its directory: newest wins) "
                        "to resume from; replays the DAG from the next "
                        "chapter bit-exactly")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    # bit-exactness needs deterministic kernels: cuBLAS (the softmax and
    # §4.4 heads) takes a pinned workspace, set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)

    failures = []
    if args.fault_plan or args.checkpoint_dir or args.resume_from:
        failures = _resilience_case(args)
    elif args.matrix:
        for i, case in enumerate(_MATRIX):
            failures += _check_case(*case, check_sim_bound=i == 0,
                                    check_overlap_ab=i in _AB_CASES,
                                    device=args.device)
    elif args.lm_matrix:
        for i, case in enumerate(_LM_MATRIX):
            failures += _lm_check_case(*case,
                                       check_overlap_ab=i in _LM_AB_CASES,
                                       device=args.device)
        if not failures:
            print("lm selftest OK: executor chapter schedule bit-exact "
                  "vs train_chapters on the BPE text source")
    else:
        failures = _check_case(args.schedule, args.nodes, args.splits,
                               args.n_train, args.neg_mode,
                               args.classifier, args.goodness_fn,
                               check_sim_bound=True, check_overlap_ab=True,
                               device=args.device)
    if failures:
        print("SELFTEST FAILED:\n  " + "\n  ".join(failures))
        return 1
    print("selftest OK: executor weight stream bit-exact vs the "
          "sequential trainer")
    return 0


if __name__ == "__main__":
    raise SystemExit(_selftest())
