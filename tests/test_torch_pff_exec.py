"""The port's PFF executor on the CPU, within the port: the reference's
bit-exactness matrix (``pff_exec._MATRIX``, with ``_AB_CASES`` as the
overlap on/off A/B) against the port's own sequential and federated
trainers, the resilience cases of ``tests/test_pff_faults.py`` (crash
retry, dead node, federated dead node, checkpoint resume with and
without head and adaptive negatives, mismatched-run rejection, elastic
rounds against ``pff.run_elastic_federated``), the kill-then-resume
subprocess pair through the CLI, and one trace through
``obs.analyze.check_invariants``.

Every run here is on N x ``cpu`` (``device="cpu"``), where the nodes
run in order; the same code runs N CUDA streams on the card, which
``chip_smoke.py`` gates at the paper's width. Bit-exactness is asked
under ``torch.use_deterministic_algorithms(True)``, as on the card."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import api, data as tdata
from repro_torch.configs.ff_mlp import FFMLPConfig
from repro_torch.core import faults, pff, pff_exec
from repro_torch.obs import analyze, export, trace as obs_trace

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    os.pardir, "src")


@pytest.fixture(autouse=True)
def deterministic_one_thread():
    """Deterministic algorithms, and one intra-op thread: these fits are
    thousands of small ops, which under the suite's parallel workers
    slow down a hundredfold when each op wakes a team of threads."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.get_num_threads())
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    yield
    torch.use_deterministic_algorithms(prev[0])
    torch.set_num_threads(prev[1])


def _cfg(splits=3, **kw):
    base = dict(layer_sizes=(784, 128, 128), epochs=splits * 2,
                splits=splits, neg_mode="random", classifier="goodness",
                goodness_fn="sumsq", batch_size=64, seed=0)
    base.update(kw)
    return FFMLPConfig(**base)


@pytest.fixture(scope="module")
def task():
    return tdata.mnist_like(n_train=520, n_test=200)


def _exec_fit(cfg, task, nodes=3, schedule="all_layers", **kw):
    return api.fit(cfg, task, backend="executor", schedule=schedule,
                   num_nodes=nodes, devices=["cpu"] * nodes, **kw)


# ---------------------------------------------------------------------------
# The bit-exactness matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row", range(len(pff_exec._MATRIX)))
def test_matrix_row_is_bit_exact_against_the_ports_trainer(row, capsys):
    failures = pff_exec._check_case(
        *pff_exec._MATRIX[row], check_overlap_ab=row in pff_exec._AB_CASES,
        check_sim_bound=row == 0, device="cpu")
    assert failures == [], capsys.readouterr().out
    out = capsys.readouterr().out
    assert out.rstrip().endswith("bit-exact")
    if row in pff_exec._AB_CASES:
        assert "overlap A/B" in out


def test_executor_result_and_counters(task):
    cfg = _cfg(neg_mode="adaptive", classifier="softmax")
    seq = api.fit(cfg, task, device="cpu")
    res = _exec_fit(cfg, task, nodes=3, profile=True)
    assert res.backend == "executor" and res.device == "cpu"
    assert pff_exec.params_bit_equal(seq.params, res.params, with_head=True)
    assert res.test_acc == seq.test_acc and res.makespan > 0
    # profile: one record per DAG task, in the sequential trainer's order
    assert [(r.kind, r.layer, r.chapter) for r in res.records] == \
        [(r.kind, r.layer, r.chapter) for r in seq.records]
    assert len(res.profile["node_busy"]) == 3
    st = res.raw.handoff
    assert st["prefetch_hits"] > 0 and st["pulls_cross"] == 0
    assert api.simulate(res, "all_layers", 3).makespan > 0


def test_executor_validates_its_arguments(task):
    cfg = _cfg()
    with pytest.raises(ValueError, match="unknown schedule"):
        pff_exec.PFFExecutor(cfg, task, "gpipe", 1, device="cpu")
    with pytest.raises(ValueError, match="sequential means"):
        pff_exec.PFFExecutor(cfg, task, "sequential", 2, device="cpu")
    with pytest.raises(ValueError, match="need 3 devices"):
        pff_exec.PFFExecutor(cfg, task, "all_layers", 3,
                             devices=["cpu"] * 2)
    with pytest.raises(KeyError):
        pff_exec.PFFExecutor(_cfg(goodness_fn="nope"), task, "all_layers",
                             1, device="cpu")
    # the card by default: no silent fall back to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.fit(cfg, task, backend="executor", num_nodes=2)


def test_sequential_schedule_on_one_node_matches(task):
    cfg = _cfg(splits=2)
    ref = api.fit(cfg, task, device="cpu")
    res = api.fit(cfg, task, backend="executor", schedule="sequential",
                  num_nodes=1, device="cpu")
    assert pff_exec.params_bit_equal(ref.params, res.params)
    assert res.raw.handoff["pulls_cross"] == 0


# ---------------------------------------------------------------------------
# Resilience: retry, dead node, checkpoint/resume, elastic
# ---------------------------------------------------------------------------

def test_crash_retry_is_bit_exact_and_counted(task):
    cfg = _cfg()
    ref = _exec_fit(cfg, task)
    plan = faults.named_plan("crash_once", splits=cfg.splits, n_layers=2,
                             num_nodes=3)
    rc = faults.ResilienceConfig(fault_plan=plan, backoff_base_s=0.001)
    res = _exec_fit(cfg, task, resilience=rc)
    assert pff_exec.params_bit_equal(ref.params, res.params)
    assert res.resilience["retries"] == 1
    assert res.resilience["faults_injected"] == {"crash": 1}
    assert res.resilience["dead_nodes"] == []


@pytest.mark.parametrize("schedule", ["all_layers", "single_layer"])
def test_dead_node_reassignment_is_bit_exact(task, schedule):
    cfg = _cfg()
    ref = api.fit(cfg, task, device="cpu")
    plan = faults.named_plan("dead_node", splits=cfg.splits, n_layers=2,
                             num_nodes=2 if schedule == "single_layer"
                             else 3)
    rc = faults.ResilienceConfig(fault_plan=plan, max_retries=1,
                                 backoff_base_s=0.001)
    nodes = 2 if schedule == "single_layer" else 3
    res = _exec_fit(cfg, task, nodes=nodes, schedule=schedule,
                    resilience=rc)
    assert pff_exec.params_bit_equal(ref.params, res.params)
    st = res.resilience
    assert st["dead_nodes"] == [nodes - 1] and st["reassignments"] == 1
    assert st["retries"] >= 1


def test_federated_dead_node_drops_shard_gracefully(task):
    cfg = _cfg()
    plan = faults.named_plan("dead_node", splits=cfg.splits, n_layers=2,
                             num_nodes=3)
    rc = faults.ResilienceConfig(fault_plan=plan, max_retries=1,
                                 backoff_base_s=0.001)
    res = _exec_fit(cfg, task, schedule="federated", resilience=rc)
    st = res.resilience
    assert st["shards_dropped"] == 1
    # node 2 owned exactly one of the 3 chapters
    assert st["chapters_skipped"] == 1 and st["reassignments"] == 0
    assert 0.0 <= res.test_acc <= 1.0
    assert all(bool(torch.isfinite(lp["w"]).all())
               for lp in res.params["layers"])


@pytest.mark.parametrize("plan_name", ["drop_handoff", "corrupt_handoff"])
def test_lost_and_poisoned_transfers_leave_the_stream_bit_exact(task,
                                                                plan_name):
    cfg = _cfg(neg_mode="adaptive", classifier="softmax")
    ref = _exec_fit(cfg, task)
    plan = faults.named_plan(plan_name, splits=cfg.splits, n_layers=2,
                             num_nodes=3)
    res = _exec_fit(cfg, task, resilience=faults.ResilienceConfig(
        fault_plan=plan))
    assert pff_exec.params_bit_equal(ref.params, res.params, with_head=True)
    st = res.raw.handoff
    if plan_name == "drop_handoff":
        assert st["prefetch_dropped"] > 0 and st["prefetch_hits"] == 0
    else:
        assert st["corrupt_detected"] == st["corrupt_injected"] > 0


def test_checkpoint_resume_bit_exact(task, tmp_path):
    cfg = _cfg()
    ref = _exec_fit(cfg, task)
    rc = faults.ResilienceConfig(checkpoint_dir=str(tmp_path), keep_last=2)
    full = _exec_fit(cfg, task, resilience=rc)
    assert pff_exec.params_bit_equal(ref.params, full.params)
    st = full.resilience
    assert st["checkpoints_written"] == cfg.splits
    assert st["checkpoint_time_s"] > 0
    # retention pruned to keep_last
    assert sorted(os.listdir(tmp_path)) == ["pff_chapter_0001.npz",
                                            "pff_chapter_0002.npz"]
    # resume from the OLDER manifest: replays the last chapter and lands
    # on the identical weight stream
    res = _exec_fit(cfg, task,
                    resume_from=str(tmp_path / "pff_chapter_0001.npz"))
    assert pff_exec.params_bit_equal(ref.params, res.params)
    assert res.resilience["resumed_from_chapter"] == 1
    # resume from the directory picks the newest
    res = _exec_fit(cfg, task, resume_from=str(tmp_path))
    assert res.resilience["resumed_from_chapter"] == 2
    assert pff_exec.params_bit_equal(ref.params, res.params)


@pytest.mark.parametrize("schedule,nodes", [("all_layers", 3),
                                            ("single_layer", 2)])
def test_checkpoint_resume_with_head_and_adaptive_neg(task, tmp_path,
                                                      schedule, nodes):
    """The recovery line carries the published negatives and the softmax
    head too (score-needing strategy + trained head)."""
    cfg = _cfg(neg_mode="adaptive", classifier="softmax")
    ref = api.fit(cfg, task, device="cpu")
    rc = faults.ResilienceConfig(checkpoint_dir=str(tmp_path))
    _exec_fit(cfg, task, nodes=nodes, schedule=schedule, resilience=rc)
    res = _exec_fit(cfg, task, nodes=nodes, schedule=schedule,
                    resume_from=str(tmp_path / "pff_chapter_0001.npz"))
    assert pff_exec.params_bit_equal(ref.params, res.params, with_head=True)


def test_resume_rejects_mismatched_run(task, tmp_path):
    cfg = _cfg()
    rc = faults.ResilienceConfig(checkpoint_dir=str(tmp_path))
    _exec_fit(cfg, task, resilience=rc)
    with pytest.raises(ValueError, match="different run"):
        _exec_fit(_cfg(seed=1), task, resume_from=str(tmp_path))
    with pytest.raises(ValueError, match="different run"):
        _exec_fit(cfg, task, nodes=2, resume_from=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _exec_fit(cfg, task, resume_from=str(tmp_path / "empty"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no pff_chapter"):
        _exec_fit(cfg, task, resume_from=str(tmp_path / "empty"))


def test_elastic_federated_matches_sequential_reference(task):
    cfg = _cfg(classifier="softmax")
    member = {0: [0, 1], 1: [0, 1, 2], 2: [2, 1]}.__getitem__
    ref = pff.run_elastic_federated(cfg, task, 3, member, device="cpu")
    rc = faults.ResilienceConfig(membership=member)
    res = _exec_fit(cfg, task, schedule="federated", resilience=rc)
    assert pff_exec.params_bit_equal(ref.params, res.params, with_head=True)
    rounds = res.resilience["elastic_rounds"]
    assert [r["live"] for r in rounds] == [[0, 1], [0, 1, 2], [1, 2]]
    assert all(abs(sum(r["weights"]) - 1.0) < 1e-9 for r in rounds)
    assert ref.history == [(0, 2), (1, 3), (2, 2)]


def test_elastic_membership_validation(task):
    cfg = _cfg()
    with pytest.raises(ValueError, match="Federated"):
        _exec_fit(cfg, task, schedule="all_layers",
                  resilience=faults.ResilienceConfig(
                      membership=lambda r: [0]))
    with pytest.raises(ValueError, match="key-only"):
        _exec_fit(_cfg(neg_mode="adaptive"), task, schedule="federated",
                  resilience=faults.ResilienceConfig(
                      membership=lambda r: [0]))
    with pytest.raises(ValueError, match="key-only"):
        pff.run_elastic_federated(_cfg(neg_mode="adaptive"), task, 3,
                                  lambda r: [0], device="cpu")
    rc = faults.ResilienceConfig(membership=lambda r: [])
    with pytest.raises(ValueError, match="no live nodes"):
        _exec_fit(cfg, task, schedule="federated", resilience=rc)
    rc = faults.ResilienceConfig(membership=lambda r: [0, 5])
    with pytest.raises(ValueError, match="outside"):
        _exec_fit(cfg, task, schedule="federated", resilience=rc)


def test_resilience_rejected_on_non_executor_backends(task):
    cfg = _cfg()
    with pytest.raises(ValueError, match="executor-backend"):
        api.fit(cfg, task, backend="sequential", device="cpu",
                resilience=faults.ResilienceConfig())
    with pytest.raises(ValueError, match="executor-backend"):
        api.fit(cfg, task, backend="federated", device="cpu",
                resume_from="/nonexistent")


def test_weighted_average_trees_order_and_checks():
    a = {"w": torch.tensor([1.0, 2.0]), "n": torch.tensor([3])}
    b = {"w": torch.tensor([3.0, 6.0]), "n": torch.tensor([3])}
    got = pff.weighted_average_trees([a, b], [0.25, 0.75])
    assert torch.equal(got["w"], a["w"] * 0.25 + b["w"] * 0.75)
    assert got["n"] is a["n"]                      # non-float: the first
    with pytest.raises(ValueError, match="weights"):
        pff.weighted_average_trees([a], [0.5, 0.5])


# ---------------------------------------------------------------------------
# Kill-then-resume through the CLI, and a trace through obs.analyze
# ---------------------------------------------------------------------------

def test_kill_then_resume_bit_exact_subprocess(tmp_path):
    """Hard-kill (os._exit) the executor mid-chapter, then resume from
    the surviving manifests; the resumed CLI gates its weight stream
    bit-exact against the fault-free sequential trainer and exits
    non-zero on divergence."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "repro_torch.core.pff_exec", "--device",
            "cpu", "--schedule", "all_layers", "--nodes", "4", "--splits",
            "4", "--n-train", "260"]
    td = str(tmp_path)
    killed = subprocess.run(
        base + ["--fault-plan", "kill_mid", "--checkpoint-dir", td],
        capture_output=True, text=True, env=env, timeout=300)
    assert killed.returncode == faults.KILL_EXIT, (
        f"stdout:\n{killed.stdout}\nstderr:\n{killed.stderr}")
    assert "injected kill at chapter 2 (mid)" in killed.stdout
    assert sorted(os.listdir(td)) == ["pff_chapter_0000.npz",
                                      "pff_chapter_0001.npz"]
    resumed = subprocess.run(
        base + ["--resume-from", td], capture_output=True, text=True,
        env=env, timeout=300)
    assert resumed.returncode == 0, (
        f"stdout:\n{resumed.stdout}\nstderr:\n{resumed.stderr}")
    assert "bit-exact vs fault-free reference" in resumed.stdout


def test_trace_passes_the_invariants_and_exports(task, tmp_path):
    cfg = _cfg(neg_mode="adaptive")
    tr = obs_trace.Tracer()
    traced = _exec_fit(cfg, task, nodes=3, trace=tr)
    assert traced.trace is tr and traced.records is not None
    window = traced.makespan
    a = analyze.analyze(tr, measured_makespan=window)
    # the CPU runs the nodes in order, so its makespan IS the serial
    # bound, and separate CPU runs of a fraction of a second spread too
    # widely to bound each other: the gate is held on the traced run's
    # own window (the critical path must fit inside it); chip_smoke.py
    # holds it against separate runs on the card
    assert analyze.check_invariants(a, window,
                                    serial_makespan=window) == []
    assert a.sum_task_s <= window
    assert a.handoff["prefetch_hits"] == traced.raw.handoff["prefetch_hits"]
    assert a.schedule == "all_layers" and a.n_layers == 2
    assert len(a.critical_path) > 0 and a.sum_task_s > 0
    # AdaptiveNEG's published negatives chain every chapter behind the
    # last one's neg_gen task: with no head beside it, the critical path
    # is every task, whatever their durations
    assert a.critical_path == [(r.kind, r.layer, r.chapter)
                               for r in traced.records]
    path = export.export(tr, str(tmp_path / "t.jsonl"), format="jsonl")
    again = analyze.analyze(export.load_jsonl(path),
                            measured_makespan=window)
    assert again.critical_path == a.critical_path
    export.export(tr, str(tmp_path / "t.json"), format="chrome")
    assert os.path.getsize(tmp_path / "t.json") > 0
