"""Deterministic fault injection + resilience policy for the PFF executor
(the port's own copy of ``repro.core.faults``, unchanged in behaviour).

A production posture for the real executor (``repro_torch.core.pff_exec``)
needs survival, not just speed — and survival logic is untestable unless
every failure mode is REPRODUCIBLE. This module provides that surface:

* ``Fault`` / ``FaultPlan`` — a seeded, schedule-addressable plan of
  failures. Each fault addresses the executor's own task coordinates
  (``kind, layer, chapter, node`` — the same addressing as
  ``pff_dag.Task``) or a hand-off transfer slot, so a test or benchmark
  can say "crash train(layer 0, chapter 1) on its owning node, twice"
  and get exactly that, every run. Fault kinds:

    crash            raise ``InjectedFault`` at task entry (before any
                     state mutation — the executor retries are clean)
    delay            sleep ``delay_ms`` at task entry on the owning node
    drop_handoff     a double-buffered transfer never arrives (the
                     consumer falls back to an on-demand pull)
    corrupt_handoff  the transferred bits arrive poisoned (NaNs) with
                     the integrity flag set — modelling a checksum
                     failure on receive; the consumer must detect it and
                     re-pull, never serve the poisoned tree
    kill             hard-kill the process (``os._exit(KILL_EXIT)``) at
                     chapter ``chapter`` — ``phase="mid"`` mid-chapter
                     (after its first train task), ``phase="post"``
                     right after the chapter checkpoint is on disk

* ``ResilienceConfig`` — the policy knob passed to
  ``api.fit(..., backend="executor", resilience=...)``: chapter-granular
  checkpointing (dir / cadence / retention), retry budget + exponential
  backoff, the fault plan to inject, and the elastic-federated
  membership callback.

* ``NAMED_PLANS`` — parameterized example plans (``named_plan``)
  surfaced as ``--fault-plan`` choices on the ``pff_exec`` CLI, so any
  injected failure is reproducible from the command line.

Determinism contract: a ``FaultPlan`` is pure data plus per-fault
trigger counters — matching consumes a trigger (``times``; ``-1`` means
every occurrence), and the executor walks tasks in the DAG's canonical
order, so a plan fires at exactly the same points in every run.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional, Sequence

KINDS = ("crash", "delay", "drop_handoff", "corrupt_handoff", "kill")

#: Exit code of a process hard-killed by a ``kill`` fault — distinctive,
#: so the kill-then-resume tests can tell an injected kill from a crash.
KILL_EXIT = 17


class InjectedFault(RuntimeError):
    """Raised by an injected ``crash`` fault. The executor's retry /
    reassignment machinery catches EXACTLY this type — real errors
    still propagate."""


@dataclasses.dataclass
class Fault:
    """One addressable failure. ``None`` fields are wildcards.

    ``task``/``layer``/``chapter``/``node`` address executor tasks for
    ``crash``/``delay`` (task in train|head|neg_gen|round); for the
    hand-off kinds ``task`` matches the slot name ("state" | "params" |
    "head" | "neg"), ``layer`` the slot's layer, ``chapter`` the
    producing version and ``node`` the destination. ``kill`` uses only
    ``chapter`` + ``phase``.
    """
    kind: str
    task: Optional[str] = None
    layer: Optional[int] = None
    chapter: Optional[int] = None
    node: Optional[int] = None
    times: int = 1                 # trigger budget; -1 = every occurrence
    delay_ms: float = 0.0          # kind == "delay"
    phase: str = "mid"             # kind == "kill": "mid" | "post"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "kill" and self.phase not in ("mid", "post"):
            raise ValueError(f"kill phase must be 'mid' or 'post', "
                             f"got {self.phase!r}")


@dataclasses.dataclass
class FaultPlan:
    """A seeded list of faults with per-fault trigger counters.

    The executor consults the plan at well-defined points (task entry,
    hand-off prefetch, chapter boundaries); each successful match
    consumes one trigger. ``fired`` counts consumed triggers per kind —
    what ``ExecResult.resilience["faults_injected"]`` reports.
    """
    faults: List[Fault] = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.reset()

    def reset(self):
        """Restore every fault's trigger budget (plans are reusable)."""
        self._remaining = [f.times for f in self.faults]
        self.fired = {}

    # ---- matching --------------------------------------------------------
    def _match(self, kind, task=None, layer=None, chapter=None, node=None):
        """First armed fault matching all non-None fields; consumes one
        trigger and returns the Fault (None = no match)."""
        for i, f in enumerate(self.faults):
            if f.kind != kind or self._remaining[i] == 0:
                continue
            if f.task is not None and f.task != task:
                continue
            if f.layer is not None and f.layer != layer:
                continue
            if f.chapter is not None and f.chapter != chapter:
                continue
            if f.node is not None and f.node != node:
                continue
            if self._remaining[i] > 0:
                self._remaining[i] -= 1
            self.fired[kind] = self.fired.get(kind, 0) + 1
            return f
        return None

    def should_crash(self, task, layer, chapter, node) -> bool:
        return self._match("crash", task, layer, chapter, node) is not None

    def delay_s(self, task, layer, chapter, node) -> float:
        f = self._match("delay", task, layer, chapter, node)
        return f.delay_ms / 1000.0 if f is not None else 0.0

    def handoff_action(self, name, node, version) -> Optional[str]:
        """"drop" / "corrupt" / None for a prefetch of slot ``name``
        (a tuple like ("state", k) or ("head",)) onto ``node`` at
        producing-chapter ``version``."""
        slot, layer = name[0], (name[1] if len(name) > 1 else None)
        for kind in ("drop_handoff", "corrupt_handoff"):
            if self._match(kind, slot, layer, version, node) is not None:
                return "drop" if kind == "drop_handoff" else "corrupt"
        return None

    def kill_now(self, chapter, phase) -> bool:
        for i, f in enumerate(self.faults):
            if (f.kind == "kill" and self._remaining[i] != 0
                    and f.phase == phase
                    and (f.chapter is None or f.chapter == chapter)):
                if self._remaining[i] > 0:
                    self._remaining[i] -= 1
                self.fired["kill"] = self.fired.get("kill", 0) + 1
                return True
        return False

    # ---- serialization (CLI / subprocess tests) --------------------------
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [dataclasses.asdict(f)
                                      for f in self.faults]})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        return cls(faults=[Fault(**f) for f in d.get("faults", [])],
                   seed=d.get("seed", 0))


@dataclasses.dataclass
class ResilienceConfig:
    """Resilience policy for ``PFFExecutor`` / ``api.fit(...,
    resilience=...)``.

    checkpoint_dir: where chapter manifests go (None = no checkpointing).
    checkpoint_every: write one manifest every N completed chapters (the
        last chapter is always written so a finished run is resumable).
    keep_last: retention — older chapter manifests are pruned.
    max_retries: per-task retry budget for injected crashes; on
        exhaustion the node is declared dead (all_layers/single_layer
        reassign its tasks to a surviving device; federated drops its
        shard).
    backoff_base_s/backoff_factor: exponential backoff between retries
        (attempt i sleeps base * factor**i — deterministic, no jitter,
        so fault tests are reproducible).
    fault_plan: the deterministic failures to inject (None = none).
    membership: elastic Federated PFF — callable ``round -> iterable of
        live node ids``; live nodes train their own shard from the
        round-start model in parallel and the aggregator averages
        weighted by live shard sizes (``pff.weighted_average_trees``).
    """
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    keep_last: int = 3
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    fault_plan: Optional[FaultPlan] = None
    membership: Optional[Callable[[int], Sequence[int]]] = None


# ---------------------------------------------------------------------------
# Named plans: reproducible failures from the command line
# (`python -m repro_torch.core.pff_exec --fault-plan <name>`).
# ---------------------------------------------------------------------------

def _crash_once(splits, n_layers, num_nodes):
    # one transient crash of the second chapter's first train task; the
    # first retry succeeds -> run stays bit-exact
    return FaultPlan([Fault("crash", task="train", layer=0,
                            chapter=min(1, splits - 1), times=1)])


def _dead_node(splits, n_layers, num_nodes):
    # the last node fails permanently: retries exhaust, its tasks are
    # reassigned (all_layers/single_layer) or its shard dropped
    # (federated)
    return FaultPlan([Fault("crash", node=max(num_nodes - 1, 0),
                            times=-1)])


def _delay_node(splits, n_layers, num_nodes):
    # a straggler: every task on node 0 starts 30 ms late
    return FaultPlan([Fault("delay", node=0, delay_ms=30.0, times=-1)])


def _drop_handoff(splits, n_layers, num_nodes):
    # every double-buffered transfer is lost; consumers must fall back
    # to on-demand pulls and the weight stream must not change
    return FaultPlan([Fault("drop_handoff", times=-1)])


def _corrupt_handoff(splits, n_layers, num_nodes):
    # every transfer arrives poisoned; the version/integrity gate must
    # detect and re-pull — a served poisoned tree would NaN the weights
    return FaultPlan([Fault("corrupt_handoff", times=-1)])


def _kill_mid(splits, n_layers, num_nodes):
    # hard-kill mid-chapter (after the chapter's first train task) —
    # resume must replay the partially-executed chapter bit-exactly
    return FaultPlan([Fault("kill", chapter=max(1, splits // 2),
                            phase="mid", times=1)])


def _kill_post(splits, n_layers, num_nodes):
    # hard-kill right after the chapter checkpoint hits disk
    return FaultPlan([Fault("kill", chapter=max(1, splits // 2),
                            phase="post", times=1)])


NAMED_PLANS = {
    "crash_once": _crash_once,
    "dead_node": _dead_node,
    "delay_node": _delay_node,
    "drop_handoff": _drop_handoff,
    "corrupt_handoff": _corrupt_handoff,
    "kill_mid": _kill_mid,
    "kill_post": _kill_post,
}


def named_plan(name, *, splits, n_layers, num_nodes) -> FaultPlan:
    """Instantiate one of ``NAMED_PLANS`` for a concrete run shape."""
    try:
        build = NAMED_PLANS[name]
    except KeyError:
        raise KeyError(f"unknown fault plan {name!r}; known: "
                       f"{', '.join(sorted(NAMED_PLANS))}") from None
    return build(splits, n_layers, num_nodes)
