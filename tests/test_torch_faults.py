"""The port's ``core.faults`` copy and the executor's hand-off slots on
the CPU: the reference's fault-plan tests (``tests/test_pff_faults.py``)
against the port's copy, a JSON plan that both packages read and fire
the same way, the DAG replay frontier, and ``pff_exec._Handoff``'s
version gate and injected drop / corrupt transfers."""
import itertools

import pytest
import torch

from repro.core import faults as jfaults
from repro_torch.core import faults, pff_dag, pff_exec


# ---------------------------------------------------------------------------
# FaultPlan semantics (pure data, no executor)
# ---------------------------------------------------------------------------

def test_fault_plan_matching_and_budget():
    plan = faults.FaultPlan([
        faults.Fault("crash", task="train", layer=0, chapter=1, times=2),
        faults.Fault("delay", node=1, delay_ms=50.0, times=-1),
    ])
    # wildcards: node is unspecified -> matches any node; budget of 2
    assert plan.should_crash("train", 0, 1, 3)
    assert plan.should_crash("train", 0, 1, 0)
    assert not plan.should_crash("train", 0, 1, 0)   # budget exhausted
    assert not plan.should_crash("train", 1, 1, 0)   # wrong layer
    assert plan.delay_s("head", 2, 0, 1) == pytest.approx(0.05)
    assert plan.delay_s("head", 2, 0, 0) == 0.0      # wrong node
    assert plan.fired == {"crash": 2, "delay": 1}
    plan.reset()
    assert plan.fired == {} and plan.should_crash("train", 0, 1, 9)


def test_fault_plan_handoff_and_kill():
    plan = faults.FaultPlan([
        faults.Fault("drop_handoff", task="state", layer=1, times=1),
        faults.Fault("corrupt_handoff", node=2, times=-1),
        faults.Fault("kill", chapter=2, phase="post", times=1),
    ])
    assert plan.handoff_action(("state", 1), 0, 0) == "drop"
    assert plan.handoff_action(("state", 1), 0, 1) is None  # budget spent
    assert plan.handoff_action(("params", 0), 2, 5) == "corrupt"
    assert not plan.kill_now(2, "mid")     # wrong phase
    assert not plan.kill_now(1, "post")    # wrong chapter
    assert plan.kill_now(2, "post")
    assert not plan.kill_now(2, "post")    # budget spent


def test_fault_plan_json_roundtrip_and_validation():
    plan = faults.FaultPlan([faults.Fault("crash", node=1, times=-1)],
                            seed=7)
    clone = faults.FaultPlan.from_json(plan.to_json())
    assert clone.seed == 7 and clone.faults == plan.faults
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.Fault("meteor")
    with pytest.raises(ValueError, match="phase"):
        faults.Fault("kill", phase="pre")
    with pytest.raises(KeyError, match="unknown fault plan"):
        faults.named_plan("nope", splits=2, n_layers=2, num_nodes=2)


def _fire_all(plan):
    """Every decision a plan makes over a sweep of executor queries, in
    one fixed order (each query consumes triggers, as a run does)."""
    out = []
    for kind, layer, chapter, node in itertools.product(
            ("train", "head", "neg_gen", "round"), (-1, 0, 1, 2),
            (0, 1, 2, 3), (0, 1, 2, 3)):
        out.append(("crash", plan.should_crash(kind, layer, chapter, node)))
        out.append(("delay", plan.delay_s(kind, layer, chapter, node)))
    for name, node, version in itertools.product(
            (("state", 0), ("state", 1), ("params", 0), ("head",),
             ("neg",)), (0, 1, 2, 3), (0, 1, 2)):
        out.append(("handoff", plan.handoff_action(name, node, version)))
    for chapter, phase in itertools.product((0, 1, 2, 3), ("mid", "post")):
        out.append(("kill", plan.kill_now(chapter, phase)))
    return out, dict(plan.fired)


def test_a_json_plan_reads_and_fires_the_same_in_both_packages():
    text = faults.FaultPlan([
        faults.Fault("crash", task="train", layer=0, chapter=1, times=2),
        faults.Fault("crash", node=3, times=-1),
        faults.Fault("delay", task="head", delay_ms=12.5, times=3),
        faults.Fault("drop_handoff", task="state", layer=1, times=1),
        faults.Fault("corrupt_handoff", node=2, chapter=1, times=-1),
        faults.Fault("kill", chapter=2, phase="post", times=1),
    ], seed=11).to_json()
    port, ref = faults.FaultPlan.from_json(text), \
        jfaults.FaultPlan.from_json(text)
    assert port.to_json() == ref.to_json() == text
    assert _fire_all(port) == _fire_all(ref)
    for name in sorted(jfaults.NAMED_PLANS):
        shape = dict(splits=4, n_layers=3, num_nodes=4)
        assert faults.named_plan(name, **shape).to_json() == \
            jfaults.named_plan(name, **shape).to_json()
    assert faults.KILL_EXIT == jfaults.KILL_EXIT == 17
    assert faults.KINDS == jfaults.KINDS
    assert faults.ResilienceConfig().__dict__ == \
        jfaults.ResilienceConfig().__dict__


# ---------------------------------------------------------------------------
# Replay frontier (the DAG property checkpoint/resume rests on)
# ---------------------------------------------------------------------------

def test_replay_frontier_is_closed_cut():
    frontier = pff_dag.replay_frontier(3, 4, 2, has_head=True,
                                       has_neg=True, strict_neg=True)
    assert all(t.chapter >= 2 for t in frontier)
    kinds = {(t.kind, t.chapter) for t in frontier}
    assert ("train", 2) in kinds and ("head", 3) in kinds
    assert len(pff_dag.replay_frontier(3, 4, 0)) == 12
    assert pff_dag.replay_frontier(3, 4, 4) == []
    with pytest.raises(ValueError, match="outside"):
        pff_dag.replay_frontier(3, 4, 5)


# ---------------------------------------------------------------------------
# _Handoff: version skew + injected drop/corrupt
# ---------------------------------------------------------------------------

def _nodes(n=2):
    return pff_exec._Nodes([torch.device("cpu")] * n)


def test_handoff_version_skew_falls_through_to_fresh_pull():
    """A slot parked at an older producing chapter must NOT satisfy a
    consumer that needs a newer version: take() pulls the live tree."""
    h = pff_exec._Handoff(_nodes(), enabled=True)
    stale = {"w": torch.zeros(2)}
    live = {"w": torch.ones(2)}
    h.prefetch(("state", 0), 1, 0, stale, src=0)    # version 0 parked
    got = h.take(("state", 0), 1, 1, live, src=0)   # version 1 wanted
    assert torch.equal(got["w"], live["w"])
    assert got["w"] is not live["w"]                # a cross-node copy
    assert h.stats["prefetch_hits"] == 0 and h.stats["pulls_cross"] == 1
    # matching version serves the parked copy (and pops when asked)
    got = h.take(("state", 0), 1, 0, live, src=0, pop=True)
    assert torch.equal(got["w"], stale["w"])
    assert (("state", 0), 1) not in h.slots and h.stats["prefetch_hits"] == 1
    # a pull from the node that holds the tree copies nothing
    assert h.take(("state", 0), 1, 1, live, src=1) is live
    assert h.stats["pulls_local"] == 1


def test_handoff_copies_are_independent_of_the_producer():
    """The parked copy keeps its bits when the producer then updates its
    own tree in place, as the trainers do."""
    h = pff_exec._Handoff(_nodes(), enabled=True)
    live = {"w": torch.ones(3)}
    h.prefetch(("params", 0), 1, 0, live, src=0)
    live["w"].mul_(5.0)
    got = h.take(("params", 0), 1, 0, live, src=0)
    assert torch.equal(got["w"], torch.ones(3))


def test_handoff_drop_and_corrupt_injection():
    plan = faults.FaultPlan([
        faults.Fault("drop_handoff", task="state", times=1),
        faults.Fault("corrupt_handoff", task="params", times=1),
    ])
    h = pff_exec._Handoff(_nodes(), enabled=True,
                          fault_cb=plan.handoff_action)
    live = {"w": torch.ones(2)}
    h.prefetch(("state", 0), 1, 0, live, src=0)     # dropped
    assert h.stats["prefetch_dropped"] == 1 and not h.slots
    h.prefetch(("params", 0), 1, 0, live, src=0)    # poisoned + flagged
    assert h.stats["corrupt_injected"] == 1
    assert bool(torch.isnan(h.slots[(("params", 0), 1)][1]["w"]).all())
    assert bool(torch.isfinite(live["w"]).all())   # the source untouched
    got = h.take(("params", 0), 1, 0, live, src=0)  # detected, re-pulled
    assert h.stats["corrupt_detected"] == 1
    assert bool(torch.isfinite(got["w"]).all())


def test_handoff_disabled_parks_nothing_and_drops_dead_node_slots():
    off = pff_exec._Handoff(_nodes(), enabled=False)
    off.prefetch(("state", 0), 1, 0, {"w": torch.ones(1)}, src=0)
    assert not off.slots and off.stats["prefetch_issued"] == 0
    h = pff_exec._Handoff(_nodes(3), enabled=True)
    for node in (1, 2):
        h.prefetch(("params", 0), node, 0, {"w": torch.ones(1)}, src=0)
    h.drop_node_slots(2)
    assert list(h.slots) == [(("params", 0), 1)]


def test_nodes_refuse_mixed_device_kinds():
    with pytest.raises(ValueError, match="all be cuda or all cpu"):
        pff_exec._Nodes([torch.device("cpu"), torch.device("meta")])
