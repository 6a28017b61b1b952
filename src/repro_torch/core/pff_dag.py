"""The PFF chapter-task DAG — the single source of truth for WHAT runs
and in WHICH ORDER, shared by the event-driven simulator
(``repro_torch.core.pff.simulate_schedule``) and, when the port reaches
it, the real multi-device executor. The port's own copy of
``repro.core.pff_dag`` (pure Python, unchanged).

With splits, FF training is a DAG of chapter-tasks
T(k, c) = "train layer k for C mini-epochs in chapter c" with

    T(k, c)  <-  T(k-1, c)   (input: layer k-1's output after chapter c)
    T(k, c)  <-  T(k, c-1)   (weights: layer k's own previous chapter)

and NO backward edges — backpropagation would add them, and they are why
GPipe/PipeDream have bubbles that PFF does not. Head and negative-
regeneration tasks hang off the train chain:

    head(c)     <-  T(L-1, c), head(c-1)     (feats + its own weights)
    neg_gen(c)  <-  T(L-1, c)                (AdaptiveNEG scores need the
                                              full chapter-c model)

``strict_neg`` additionally gates T(0, c) on neg_gen(c-1): that is the
executor's bit-exact mode (chapter c trains on negatives regenerated
from the FULL chapter-(c-1) model, exactly like the sequential trainer).
The paper's All-Layers AdaptiveNEG instead uses negatives "at whatever
freshness is available" — the simulator models that relaxation by
leaving the edge out.

Node assignments (N nodes, L layers, S chapters):
  sequential    — one node runs everything.
  single_layer  — node k owns layer k; it re-runs the forward pass of
                  layers < k over the train set each chapter (the
                  paper's Algorithm 1 lines 3-5).
  all_layers    — node i executes whole chapters c = i (mod N)
                  (Algorithm 2); it computes its own forward features
                  while it trains, so no extra forward tasks appear.
  federated     — all_layers assignment + node-local data shards.
"""
from __future__ import annotations

import dataclasses
from typing import List

SCHEDULES = ("sequential", "single_layer", "all_layers", "federated")


@dataclasses.dataclass(frozen=True)
class Task:
    kind: str                  # train | head | neg_gen | local_head
    layer: int                 # -1 for non-layer tasks
    chapter: int


def node_of(schedule: str, num_nodes: int, *, layer: int,
            chapter: int) -> int:
    """Which node owns a train-task (schedule's static assignment)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"expected one of {SCHEDULES}")
    if schedule == "sequential" or num_nodes == 1:
        return 0
    if schedule == "single_layer":
        return layer % num_nodes
    # all_layers / federated: node per chapter
    return chapter % num_nodes


def head_node_of(schedule: str, num_nodes: int, *, n_layers: int,
                 chapter: int) -> int:
    """The head trains where the chapter's last layer trained."""
    return node_of(schedule, num_nodes, layer=n_layers - 1,
                   chapter=chapter)


def neg_node_of(schedule: str, num_nodes: int, *, chapter: int) -> int:
    """Negative regeneration: in Single-Layer the LAST node generates
    and publishes for everyone (it is the only one holding the full
    model — the paper's observed serialization); in All-Layers/Federated
    the node that ran the chapter regenerates its own (parallel)."""
    if schedule == "single_layer" and num_nodes > 1:
        return num_nodes - 1
    return node_of(schedule, num_nodes, layer=0, chapter=chapter)


def chapter_train_nodes(schedule: str, num_nodes: int, n_layers: int, *,
                        chapter: int) -> List[int]:
    """All nodes that run train tasks in ``chapter`` — the consumers of
    anything published FOR that chapter (e.g. regenerated negatives)."""
    if schedule == "single_layer" and num_nodes > 1:
        return sorted({k % num_nodes for k in range(n_layers)})
    return [node_of(schedule, num_nodes, layer=0, chapter=chapter)]


def handoff_targets(schedule: str, num_nodes: int, *, n_layers: int,
                    splits: int, layer: int, chapter: int,
                    has_head: bool = False, has_neg: bool = False):
    """Cross-node consumers of train(layer, chapter)'s fresh weights —
    what the executor's double-buffered hand-off prefetches while the
    producing node is still busy. Derived from the same ``deps()`` edges
    and node assignments the dispatch order walks, so a prefetched copy
    can never be consumed at the wrong version.

    Returns ``(next_train_node, param_consumer_nodes)``:

    * ``next_train_node`` — the node that trains this layer in chapter
      + 1 and therefore needs the FULL (params, opt, ...) state; None
      when that is the producing node itself (single_layer: layer k
      lives on node k every chapter) or when this is the last chapter.
    * ``param_consumer_nodes`` — nodes that need only the layer PARAMS
      within this same chapter: the Algorithm-1 forward recompute of
      later layers, the softmax-head node and the negative-regeneration
      node (Single-Layer only — in All-Layers/Federated every
      within-chapter consumer runs on the chapter's own node).
    """
    src = node_of(schedule, num_nodes, layer=layer, chapter=chapter)
    nxt = None
    if chapter + 1 < splits:
        n = node_of(schedule, num_nodes, layer=layer, chapter=chapter + 1)
        if n != src:
            nxt = n
    params = set()
    if schedule == "single_layer" and num_nodes > 1:
        for k in range(layer + 1, n_layers):
            params.add(node_of(schedule, num_nodes, layer=k,
                               chapter=chapter))
        if has_head:
            params.add(head_node_of(schedule, num_nodes,
                                    n_layers=n_layers, chapter=chapter))
        if has_neg:
            params.add(neg_node_of(schedule, num_nodes, chapter=chapter))
    params.discard(src)
    return nxt, sorted(params)


def build_tasks(n_layers: int, splits: int, *, has_head: bool = False,
                has_neg: bool = False,
                has_local_heads: bool = False) -> List[Task]:
    """All tasks in canonical (sequential-trainer) order — a valid
    topological order of ``deps``, which is what both the simulator's
    event loop and the executor's dispatch loop walk.

    has_local_heads: the Performance-Optimized goodness path (paper
    §4.4) — each layer's local softmax head is a per-layer dependent of
    that layer's train task, owned by the same node. The executor fuses
    each local_head into its train task (they share one two-layer-deep
    backprop call — that is the §4.4 objective), which preserves this
    order exactly."""
    tasks: List[Task] = []
    for c in range(splits):
        for k in range(n_layers):
            tasks.append(Task("train", k, c))
            if has_local_heads:
                tasks.append(Task("local_head", k, c))
        if has_head:
            tasks.append(Task("head", n_layers, c))
        if has_neg:
            tasks.append(Task("neg_gen", -1, c))
    return tasks


def replay_frontier(n_layers: int, splits: int, start_chapter: int, *,
                    has_head: bool = False, has_neg: bool = False,
                    strict_neg: bool = False,
                    has_local_heads: bool = False,
                    head_feedback: bool = False) -> List[Task]:
    """The tasks a resumed executor must (re)execute when every chapter
    < ``start_chapter`` has completed — i.e. the DAG restricted to
    chapters >= ``start_chapter``, in canonical order.

    FF's core property makes this cut well-defined: every dependency
    edge points backward by at most one chapter (there are NO backward
    edges at all — the reason a chapter checkpoint is a consistent
    recovery line, unlike a mid-step backprop snapshot). This helper
    VERIFIES that closure — every dep of a frontier task either belongs
    to a completed chapter or precedes it inside the frontier — so a
    resume from a bad chapter index fails loudly instead of replaying
    an inconsistent stream.
    """
    if not 0 <= start_chapter <= splits:
        raise ValueError(f"start_chapter {start_chapter} outside "
                         f"[0, {splits}]")
    frontier = [t for t in build_tasks(n_layers, splits,
                                       has_head=has_head, has_neg=has_neg,
                                       has_local_heads=has_local_heads)
                if t.chapter >= start_chapter]
    seen: set = set()
    for t in frontier:
        for d in deps(t, n_layers, has_head=has_head, has_neg=has_neg,
                      strict_neg=strict_neg,
                      has_local_heads=has_local_heads,
                      head_feedback=head_feedback):
            if d.chapter >= start_chapter and d not in seen:
                raise ValueError(
                    f"chapter {start_chapter} is not a valid replay "
                    f"frontier: {t} depends on unexecuted {d}")
        seen.add(t)
    return frontier


def deps(task: Task, n_layers: int, *, has_head: bool = False,
         has_neg: bool = False, strict_neg: bool = False,
         has_local_heads: bool = False,
         head_feedback: bool = False) -> List[Task]:
    """Direct dependencies of ``task`` (see module docstring).

    head_feedback: LM chapters with tied embeddings — the head task
    updates the shared embed table, and every chapter-c train task
    embeds its tokens with the post-head-(c-1) table. The edge is
    recorded at layer 0 only; layers > 0 inherit it through their
    train(k-1, c) chain, so the closure is unchanged."""
    k, c = task.layer, task.chapter
    out: List[Task] = []
    if task.kind == "train":
        if k > 0:
            out.append(Task("train", k - 1, c))
        if c > 0:
            out.append(Task("train", k, c - 1))
            if has_local_heads:
                # §4.4: the chapter-c train task backprops THROUGH the
                # layer's local head, so it consumes the head weights
                # produced by chapter-(c-1)'s local_head task
                out.append(Task("local_head", k, c - 1))
            if has_head and head_feedback and k == 0:
                out.append(Task("head", n_layers, c - 1))
        if k == 0 and c > 0 and has_neg and strict_neg:
            out.append(Task("neg_gen", -1, c - 1))
    elif task.kind == "local_head":
        out.append(Task("train", k, c))
        if c > 0:
            out.append(Task("local_head", k, c - 1))
    elif task.kind == "head":
        out.append(Task("train", n_layers - 1, c))
        if c > 0:
            out.append(Task("head", n_layers, c - 1))
    elif task.kind == "neg_gen":
        out.append(Task("train", n_layers - 1, c))
    else:
        raise ValueError(f"unknown task kind {task.kind!r}")
    return out
