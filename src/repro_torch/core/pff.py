"""Pipeline Forward-Forward (PFF): the canonical chapter-schedule trainer
and the schedule simulator (``repro.core.pff``'s counterpart).

With splits, FF training is a DAG of chapter-tasks T(k, c) = "train
layer k for C epochs in chapter c" with forward-only dependencies
(``core.pff_dag``). Because the DAG, not the node assignment, fixes the
weight-update order, Sequential, Single-Layer and All-Layers PFF give
the same weight stream and differ only in wall-clock. This module:

  * ``run_chapter_schedule`` runs the chapter schedule once on one
    device, timing every task (the facade's ``sequential`` and
    ``federated`` backends; call ``repro_torch.api.fit``);
  * ``simulate_schedule`` replays those timings under each schedule's
    node assignment (event-driven, over ``pff_dag``) to obtain the
    distributed training time, utilization and bubble fraction.

Federated PFF trains chapter c on node (c mod N)'s shard
(``federated_shards``). Elastic Federated PFF (``run_elastic_federated``)
is the sequential reference of the executor's membership-aware rounds
(``core.pff_exec``): both go through ``elastic_node_round`` and
``weighted_average_trees``.

Every random draw comes from one key (``core.rng``), folded exactly as
the reference folds its jax key: ``fold_in(key, 999)`` for negatives,
``fold_in(key, chapter)`` then ``fold_in(kc, layer)`` per train task,
``fold_in(kc, 77)`` for the head, ``fold_in(kneg, chapter)`` for
regeneration.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import data as data_lib, optim
from repro_torch.convert import tree_map
from repro_torch.core import ff, ff_mlp, pff_dag, strategies
from repro_torch.core.rng import TorchKey
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace


# ---------------------------------------------------------------------------
# Canonical chapter-schedule trainer (times every task)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TaskRecord:
    kind: str                  # train | forward | neg_gen | head | publish
    layer: int                 # -1 for non-layer tasks
    chapter: int
    duration: float


@dataclasses.dataclass
class TrainResult:
    params: dict
    records: List[TaskRecord]
    test_acc: float
    train_acc: float
    cfg: object
    history: List[Tuple[int, float]]       # (chapter, test_acc) probes


def _sync(dev):
    """Waits for the card, so a task's host-clock time is its run time."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_chapter_schedule(cfg, task: data_lib.ImageTask, *, probe_every=0,
                         node_data: Optional[List[np.ndarray]] = None,
                         num_nodes: int = 1, verbose=False, device=None,
                         key=None) -> TrainResult:
    """Runs the paper's canonical chapter schedule (the facade's
    ``sequential`` / ``federated`` backends; call ``api.fit``).

    Strategy variation comes from the ``core.strategies`` registries;
    this driver walks the chapter x layer task order and times every
    task (behind ``torch.cuda.synchronize()`` on the card).

    node_data: per-node index arrays (Federated PFF): chapter c uses
    node (c % num_nodes)'s shard.
    device: ``None`` = ``cuda`` (raises without a GPU); ``"cpu"`` runs
    the plain PyTorch path.
    key: the run's random key (default ``TorchKey(cfg.seed)``).
    """
    dev = resolve_device(device)
    good = strategies.goodness.get(cfg.goodness_fn)
    neg = strategies.negatives.get(cfg.neg_mode)
    cls = strategies.classifier.get(cfg.classifier)
    key = TorchKey(cfg.seed) if key is None else key
    params = ff_mlp.init(cfg, key, dev)
    opt = ff_mlp.opt_init(params)
    records: List[TaskRecord] = []
    history = []

    S = cfg.splits
    C = max(cfg.epochs // cfg.splits, 1)
    n_layers = len(params["layers"])
    x_all = torch.as_tensor(task.x_train, device=dev)
    y_all = torch.as_tensor(task.y_train, device=dev)
    impl = ff_mlp.kernel_impl(cfg)
    has_neg = good.uses_negatives and neg.regenerates
    tr = obs_trace.active()

    # Chapter-invariant overlays and the layer-0 normalization, hoisted
    # out of the chapter loop (the negative one changes only on
    # regeneration). The initial negatives see params=None/scores=None:
    # every strategy degrades to key-only wrong labels then.
    kneg = key.fold_in(999)
    with torch.no_grad():
        if good.uses_negatives:
            xp0 = ff_mlp._norm(ff.overlay_label(x_all, y_all,
                                                cfg.num_classes))
            xn0 = ff_mlp._norm(neg.fn(kneg, cfg, None, x_all, y_all, None))
        if not good.uses_negatives or cls.trains_head:
            x_neutral = ff.overlay_neutral(x_all, cfg.num_classes)
            if not good.uses_negatives:
                xk0 = ff_mlp._norm(x_neutral)

    for chapter in range(S):
        idx = None
        if node_data is not None:
            idx = torch.as_tensor(node_data[chapter % num_nodes],
                                  device=dev)
        lrs = torch.stack([
            optim.cooldown_lr(cfg.lr_ff, chapter * C + e, cfg.epochs,
                              cfg.cooldown_after) for e in range(C)])
        lrs_head = lrs * (cfg.lr_softmax / cfg.lr_ff)
        kc = key.fold_in(chapter)

        # per-chapter inputs: activations flow layer to layer, extras
        # (labels) do not
        if good.uses_negatives:
            acts = (xp0 if idx is None else xp0[idx],
                    xn0 if idx is None else xn0[idx])
            extras = ()
        else:
            acts = (xk0 if idx is None else xk0[idx],)
            extras = (y_all if idx is None else y_all[idx],)

        for k in range(n_layers):
            with tr.span("task:train", kind="train", layer=k,
                         chapter=chapter, node=0):
                t0 = time.perf_counter()
                state = good.train_chapter(
                    good.get_state(params, opt, k), acts, extras, lrs,
                    kc.fold_in(k), cfg=cfg, epochs=C)
                good.set_state(params, opt, k, state)
                if k + 1 < n_layers:
                    # propagate the data through the freshly trained layer
                    with torch.no_grad():
                        acts = tuple(ff_mlp.fwd_norm(state[0], a, impl=impl)
                                     for a in acts)
                _sync(dev)
                records.append(TaskRecord(
                    "train", k, chapter, time.perf_counter() - t0))

        # softmax head (trained alongside, layer-local: paper §3)
        if cls.trains_head:
            with tr.span("task:head", kind="head", layer=n_layers,
                         chapter=chapter, node=0):
                t0 = time.perf_counter()
                xn_all = x_neutral if idx is None else x_neutral[idx]
                with torch.no_grad():
                    feats = ff_mlp.softmax_feats(params["layers"], xn_all,
                                                 impl=impl)
                params["head"], opt["head"] = ff_mlp.train_head_chapter(
                    params["head"], opt["head"], feats,
                    y_all if idx is None else y_all[idx],
                    lrs_head, kc.fold_in(77), batch=cfg.batch_size, epochs=C)
                _sync(dev)
                records.append(TaskRecord(
                    "head", n_layers, chapter, time.perf_counter() - t0))

        # negative regeneration (UpdateXNEG)
        if has_neg:
            with tr.span("task:neg_gen", kind="neg_gen", layer=-1,
                         chapter=chapter, node=0):
                t0 = time.perf_counter()
                with torch.no_grad():
                    # only needs_scores strategies see the live model
                    scores = None
                    if neg.needs_scores:
                        scores = _class_scores_chunked(params, x_all, cfg)
                    xn0 = ff_mlp._norm(neg.fn(
                        kneg.fold_in(chapter), cfg,
                        params if neg.needs_scores else None,
                        x_all, y_all, scores))
                _sync(dev)
                records.append(TaskRecord(
                    "neg_gen", -1, chapter, time.perf_counter() - t0))

        if probe_every and (chapter + 1) % probe_every == 0:
            with torch.no_grad():
                acc = ff_mlp.accuracy(params, task.x_test, task.y_test,
                                      cfg.num_classes, good.eval_mode(cfg),
                                      impl=impl)
            history.append((chapter + 1, acc))
            if verbose:
                print(f"  chapter {chapter + 1}/{S}: test acc {acc:.4f}")

    mode = good.eval_mode(cfg)
    with torch.no_grad():
        test_acc = ff_mlp.accuracy(params, task.x_test, task.y_test,
                                   cfg.num_classes, mode, impl=impl)
        train_acc = ff_mlp.accuracy(params, task.x_train[:2000],
                                    task.y_train[:2000], cfg.num_classes,
                                    mode, impl=impl)
    return TrainResult(params, records, test_acc, train_acc, cfg, history)


def _class_scores_chunked(params, x, cfg, chunk=2000):
    """Train-set goodness scores for AdaptiveNEG regeneration, through
    the chunked loop ``accuracy`` uses (10 x ``chunk`` rows per
    ``ff_dense`` call)."""
    impl = ff_mlp.kernel_impl(cfg)
    with obs_trace.active().span("mlp.neg.score", device=x.device):
        return ff_mlp.chunked_scores(
            lambda xc: ff_mlp.goodness_class_scores(params, xc,
                                                    cfg.num_classes,
                                                    impl=impl),
            x, chunk=chunk, device=x.device)


# ---------------------------------------------------------------------------
# Event-driven schedule simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    schedule: str
    num_nodes: int
    makespan: float
    sequential_time: float
    speedup: float
    utilization: float
    bubble_fraction: float
    node_busy: List[float]


def task_durations(records: List[TaskRecord], *, reducer=np.median):
    """Duration per (kind, layer), reduced with ``reducer`` (the median
    by default: robust to the first, warm-up occurrence of each task)."""
    acc: Dict[Tuple[str, int], List[float]] = {}
    for r in records:
        acc.setdefault((r.kind, r.layer), []).append(r.duration)
    return {k: float(reducer(v)) for k, v in acc.items()}


def simulate_schedule(records: List[TaskRecord], schedule: str,
                      num_nodes: int, *, comm_time: float = 0.0,
                      forward_frac: float = 0.18,
                      reducer=np.median) -> SimResult:
    """Replays the ``pff_dag`` task DAG under a node assignment.

    forward_frac: cost of re-running the forward pass of ONE layer over
    the train set, as a fraction of one train task (Single-Layer,
    Algorithm 1 lines 3-5).

    Negatives are used at whatever freshness is available: they do NOT
    gate the next chapter's start (``strict_neg=False`` in the DAG);
    their cost appears only as node busy time, as in the paper's
    All-Layers AdaptiveNEG.
    """
    dur = task_durations(records, reducer=reducer)
    layers = sorted({r.layer for r in records if r.kind == "train"})
    chapters = sorted({r.chapter for r in records if r.kind == "train"})
    L, S = len(layers), len(chapters)
    has_head = any(k == "head" for k, _ in dur)
    has_neg = any(k == "neg_gen" for k, _ in dur)
    has_local = any(k == "local_head" for k, _ in dur)

    t_train = {k: dur[("train", k)] for k in layers}
    t_head = dur.get(("head", L), 0.0)
    t_neg = dur.get(("neg_gen", -1), 0.0)
    t_local = {k: dur.get(("local_head", k), 0.0) for k in layers}
    # fair sequential baseline: same median task costs, one node
    seq_total = S * (sum(t_train.values()) + (t_head if has_head else 0.0)
                     + (t_neg if has_neg else 0.0)
                     + (sum(t_local.values()) if has_local else 0.0))

    def owner(task: pff_dag.Task) -> int:
        if task.kind == "head":
            return pff_dag.head_node_of(schedule, num_nodes, n_layers=L,
                                        chapter=task.chapter)
        if task.kind == "neg_gen":
            return pff_dag.neg_node_of(schedule, num_nodes,
                                       chapter=task.chapter)
        # train / local_head: a local head trains where its layer trains
        return pff_dag.node_of(schedule, num_nodes, layer=task.layer,
                               chapter=task.chapter)

    def cost(task: pff_dag.Task) -> float:
        if task.kind == "head":
            return t_head
        if task.kind == "neg_gen":
            return t_neg
        if task.kind == "local_head":
            return t_local[task.layer]
        extra = 0.0
        if schedule == "single_layer" and task.layer > 0:
            # re-forward layers < k over the train set (Algorithm 1)
            extra = forward_frac * sum(t_train[j]
                                       for j in range(task.layer))
        return extra + t_train[task.layer]

    node_free = [0.0] * num_nodes
    node_busy = [0.0] * num_nodes
    done: Dict[pff_dag.Task, float] = {}

    for task in pff_dag.build_tasks(L, S, has_head=has_head,
                                    has_neg=has_neg,
                                    has_local_heads=has_local):
        n = owner(task)
        start = node_free[n]
        for dep in pff_dag.deps(task, L, has_head=has_head,
                                has_neg=has_neg,
                                has_local_heads=has_local):
            start = max(start, done[dep] +
                        (comm_time if owner(dep) != n else 0.0))
        t = cost(task)
        end = start + t
        node_free[n] = end
        node_busy[n] += t
        done[task] = end

    makespan = max(node_free)
    speedup = seq_total / makespan if makespan > 0 else 1.0
    util = sum(node_busy) / (num_nodes * makespan) if makespan else 1.0
    return SimResult(schedule, num_nodes, makespan, seq_total, speedup,
                     util, 1.0 - util, node_busy)


# ---------------------------------------------------------------------------
# Federated PFF (trains on node-local shards)
# ---------------------------------------------------------------------------

def federated_shards(cfg, task: data_lib.ImageTask, num_nodes: int):
    """The canonical federated shard split: a seed-deterministic numpy
    permutation dealt round-robin (bit-identical to the reference's)."""
    rng = np.random.default_rng(cfg.seed)
    order = rng.permutation(len(task.x_train))
    return [order[i::num_nodes] for i in range(num_nodes)]


def run_federated_schedule(cfg, task: data_lib.ImageTask, num_nodes: int,
                           **kw) -> TrainResult:
    """Federated PFF's weight stream (the facade's ``federated``
    backend)."""
    return run_chapter_schedule(cfg, task,
                                node_data=federated_shards(cfg, task,
                                                           num_nodes),
                                num_nodes=num_nodes, **kw)


# ---------------------------------------------------------------------------
# Elastic Federated PFF: membership-aware rounds + weighted aggregation
# ---------------------------------------------------------------------------

def _map_trees(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_trees(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map_trees(fn, *(t[i] for t in trees))
                           for i in range(len(first)))
    return fn(*trees)


def weighted_average_trees(trees, weights):
    """Leaf-wise weighted average of trees: the federated round
    aggregator. ``weights`` are Python floats (normalized live-shard
    fractions); accumulation walks ``trees`` in the given order, in f32,
    so two callers passing the same trees in the same order get
    BIT-IDENTICAL results (the elastic executor is checked against the
    sequential reference this way). Non-float leaves must agree across
    trees and are taken from the first."""
    if len(trees) != len(weights) or not trees:
        raise ValueError(f"{len(trees)} trees vs {len(weights)} weights")

    def avg(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[0]
        acc = leaves[0] * weights[0]
        for leaf, w in zip(leaves[1:], weights[1:]):
            acc = acc + leaf * w
        return acc
    return _map_trees(avg, *trees)


def elastic_node_round(good, cfg, states, head_state, acts, extras, lrs,
                       lrs_head, key_node, *, epochs, impl, y=None,
                       x_neutral=None, train_head=False):
    """One node's shard-local work for one elastic round, starting from
    (already copied) round-start ``states``/``head_state``.

    This is THE round math: the sequential reference
    (``run_elastic_federated``) and the executor's elastic driver both
    call exactly this function, which is what makes the multi-node
    aggregate bit-checkable against the single-device one. The chapter
    trainers update their inputs in place: callers pass per-node copies,
    never the round-start globals themselves.
    """
    out_states = []
    for k, st in enumerate(states):
        st = good.train_chapter(st, acts, extras, lrs, key_node.fold_in(k),
                                cfg=cfg, epochs=epochs)
        out_states.append(st)
        if k + 1 < len(states):
            with torch.no_grad():
                acts = tuple(ff_mlp.fwd_norm(st[0], a, impl=impl)
                             for a in acts)
    if train_head:
        with torch.no_grad():
            feats = ff_mlp.softmax_feats([s[0] for s in out_states],
                                         x_neutral, impl=impl)
        head, oph = ff_mlp.train_head_chapter(
            head_state[0], head_state[1], feats, y, lrs_head,
            key_node.fold_in(77), batch=cfg.batch_size, epochs=epochs)
        head_state = (head, oph)
    return out_states, head_state


def _check_membership(live, num_nodes, r):
    live = sorted(set(int(n) for n in live))
    if not live:
        raise ValueError(f"membership callback returned no live nodes "
                         f"for round {r}")
    bad = [n for n in live if not 0 <= n < num_nodes]
    if bad:
        raise ValueError(f"membership round {r}: node ids {bad} outside "
                         f"[0, {num_nodes})")
    return live


def _copy_tree(tree):
    return tree_map(lambda t: t.clone(), tree)


def run_elastic_federated(cfg, task: data_lib.ImageTask, num_nodes: int,
                          membership, *, device=None,
                          key=None) -> TrainResult:
    """Sequential reference for ELASTIC Federated PFF (the executor's
    ``resilience.membership`` mode is bit-checked against this).

    Per round r (= one chapter's worth of work, cfg.splits rounds):
    ``membership(r)`` names the live nodes; each live node trains a COPY
    of the round-start model on ITS OWN shard for C mini-epochs, and the
    aggregator replaces the global model with the live results averaged
    by live shard sizes (``weighted_average_trees``), the nodes in
    sorted order. Nodes joining or leaving between rounds change only
    which shards contribute and their weights.

    Key-only negative strategies only: score-needing (AdaptiveNEG)
    regeneration reads the full global model, which does not exist
    mid-round on any single node.
    device / key: as ``run_chapter_schedule`` takes them.
    """
    good = strategies.goodness.get(cfg.goodness_fn)
    neg = strategies.negatives.get(cfg.neg_mode)
    cls = strategies.classifier.get(cfg.classifier)
    if good.uses_negatives and neg.regenerates and neg.needs_scores:
        raise ValueError(
            f"elastic federated membership supports key-only negative "
            f"strategies; {cfg.neg_mode!r} needs full-model scores")
    dev = resolve_device(device)
    key = TorchKey(cfg.seed) if key is None else key
    kneg = key.fold_in(999)
    params = ff_mlp.init(cfg, key, dev)
    opt = ff_mlp.opt_init(params)
    S = cfg.splits
    C = max(cfg.epochs // cfg.splits, 1)
    n_layers = len(params["layers"])
    impl = ff_mlp.kernel_impl(cfg)
    x_all = torch.as_tensor(task.x_train, device=dev)
    y_all = torch.as_tensor(task.y_train, device=dev)
    shards = [torch.as_tensor(s, device=dev)
              for s in federated_shards(cfg, task, num_nodes)]
    train_head = cls.trains_head

    with torch.no_grad():
        if good.uses_negatives:
            xp0 = ff_mlp._norm(ff.overlay_label(x_all, y_all,
                                                cfg.num_classes))
            xn0 = ff_mlp._norm(neg.fn(kneg, cfg, None, x_all, y_all, None))
        else:
            xk0 = ff_mlp._norm(ff.overlay_neutral(x_all, cfg.num_classes))
        if train_head or not good.uses_negatives:
            x_neutral = ff.overlay_neutral(x_all, cfg.num_classes)

    states = [good.get_state(params, opt, k) for k in range(n_layers)]
    head_state = (params["head"], opt["head"])
    history = []
    for r in range(S):
        live = _check_membership(membership(r), num_nodes, r)
        history.append((r, len(live)))
        lrs = torch.stack([
            optim.cooldown_lr(cfg.lr_ff, r * C + e, cfg.epochs,
                              cfg.cooldown_after) for e in range(C)])
        lrs_head = lrs * (cfg.lr_softmax / cfg.lr_ff)
        kr = key.fold_in(r)
        if good.uses_negatives and neg.regenerates and r > 0:
            with torch.no_grad():
                xn0 = ff_mlp._norm(neg.fn(kneg.fold_in(r - 1), cfg, None,
                                          x_all, y_all, None))
        per_node = {}
        for node in live:
            idx = shards[node]
            if good.uses_negatives:
                acts, extras = (xp0[idx], xn0[idx]), ()
            else:
                acts, extras = (xk0[idx],), (y_all[idx],)
            per_node[node] = elastic_node_round(
                good, cfg, [_copy_tree(st) for st in states],
                _copy_tree(head_state), acts, extras, lrs, lrs_head,
                kr.fold_in(node), epochs=C, impl=impl,
                y=y_all[idx] if train_head else None,
                x_neutral=x_neutral[idx] if train_head else None,
                train_head=train_head)
        total = float(sum(len(shards[n]) for n in live))
        w = [len(shards[n]) / total for n in live]
        with torch.no_grad():
            states = [weighted_average_trees(
                [per_node[n][0][k] for n in live], w)
                for k in range(n_layers)]
            if train_head:
                head_state = weighted_average_trees(
                    [per_node[n][1] for n in live], w)

    final = {**good.export(states), "head": head_state[0]}
    mode = good.eval_mode(cfg)
    with torch.no_grad():
        test_acc = ff_mlp.accuracy(final, task.x_test, task.y_test,
                                   cfg.num_classes, mode, impl=impl)
        train_acc = ff_mlp.accuracy(final, task.x_train[:2000],
                                    task.y_train[:2000], cfg.num_classes,
                                    mode, impl=impl)
    return TrainResult(final, [], test_acc, train_acc, cfg, history)
