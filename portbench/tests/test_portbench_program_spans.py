"""The readers of the program's spans and counters give hand-computed
values on a hand-built run, None where the run has no program trace,
and, on the card, each cell's traced run reports every one it lists
(run on the card: ``python -m pytest portbench/tests -m card``)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import run as bench_run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"attn_chunked_pct.lm", "attn_chunked_useful_pct.lm", "prefix_pct.lm",
       "head_ce_pct.lm", "adam_pct.lm", "neg_score_pct.mlp",
       "adam_pct.mlp"}


def span(name, t0, t1, device_s, sid, parent=None):
    return {"name": name, "t0": t0, "t1": t1, "thread": "MainThread",
            "attrs": {}, "id": sid, "parent": parent, "device_s": device_s}


def make_run(unit, program, window_s=10.0):
    run = bench_run.Run(cell={}, unit=unit, work=0.0, chapters=1,
                        window_s=window_s, setup_s=0.0, peak_bytes=0,
                        spans=[], trace=None)
    run.program = program
    return run


LM = {"meta": {}, "events": [],
      "counters": {"attn.chunked.pairs": 800.0,
                   "attn.chunked.visible_pairs": 404.0},
      "spans": [
          span("lm.negatives", 0.00, 0.01, 0.05, 2, 1),
          span("lm.prefix", 0.01, 0.02, 1.0, 3, 1),
          span("attn.chunked.fwd", 0.02, 0.03, 2.0, 5, 4),
          span("lm.block.fwd", 0.02, 0.04, 2.5, 4, 1),
          span("attn.chunked.bwd", 0.04, 0.05, 3.0, 7, 6),
          span("lm.block.bwd", 0.04, 0.06, 3.5, 6, 1),
          span("lm.adam", 0.06, 0.07, 0.25, 8, 1),
          span("lm.block", 0.00, 0.30, 8.0, 1),
          span("lm.head.prefix", 0.30, 0.31, 0.5, 10, 9),
          span("lm.head.ce", 0.31, 0.32, 0.75, 11, 9),
          span("lm.head.adam", 0.32, 0.33, 0.125, 12, 9),
          span("lm.head", 0.30, 0.50, 1.5, 9),
      ]}

MLP = {"meta": {}, "events": [], "counters": {},
       "spans": [
           span("mlp.perm", 0.0, 0.1, None, 2, 1),
           span("mlp.fwd", 0.1, 0.2, 1.0, 4, 3),
           span("mlp.grad", 0.1, 0.3, 2.0, 3, 1),
           span("mlp.adam", 0.3, 0.4, 0.5, 5, 1),
           span("mlp.layer", 0.0, 0.5, 3.0, 1),
           span("mlp.adam", 0.6, 0.7, 0.25, 7, 6),
           span("mlp.layer", 0.5, 1.0, 3.0, 6),
           span("mlp.neg.score", 1.0, 1.5, 4.0, 8),
           span("mlp.neg.draw", 1.5, 1.6, 0.5, 9),
       ]}

# value by hand: summed device_s over the 10 s window, in percent
BY_HAND = [
    ("attn_chunked_pct.lm", "tokens", LM, 100.0 * (2.0 + 3.0) / 10.0),
    ("attn_chunked_useful_pct.lm", "tokens", LM, 100.0 * 404.0 / 800.0),
    ("prefix_pct.lm", "tokens", LM, 100.0 * (1.0 + 0.5) / 10.0),
    ("head_ce_pct.lm", "tokens", LM, 100.0 * 0.75 / 10.0),
    ("adam_pct.lm", "tokens", LM, 100.0 * (0.25 + 0.125) / 10.0),
    ("neg_score_pct.mlp", "samples", MLP, 100.0 * 4.0 / 10.0),
    ("adam_pct.mlp", "samples", MLP, 100.0 * (0.5 + 0.25) / 10.0),
]


def test_every_new_metric_has_a_case_and_an_entry():
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {name for name, *_ in BY_HAND} == NEW and NEW <= listed


@pytest.mark.parametrize("name,unit,program,want", BY_HAND,
                         ids=[c[0] for c in BY_HAND])
def test_reader_by_hand(name, unit, program, want):
    assert bench_run.reader(name)(make_run(unit, program)) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_gives_none_without_a_program_trace(name):
    assert bench_run.reader(name)(make_run("tokens", None)) is None


@pytest.mark.parametrize("name", ["attn_chunked_pct.lm", "prefix_pct.lm",
                                  "adam_pct.mlp"])
def test_device_share_gives_none_where_no_span_has_a_device_time(name):
    cpu = {**LM, "spans": [dict(s, device_s=None) for s in LM["spans"]
                           + MLP["spans"]]}
    assert bench_run.reader(name)(make_run("tokens", cpu)) is None


def test_reader_drains_the_profiler_bound_tracer_once():
    """A traced run with no program dict takes the program's
    profiler-bound tracer, and the readers after the first read the
    same dict from the run."""
    import torch

    from repro_torch.obs import trace as obs_trace

    obs_trace.take_profiled()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tr = obs_trace.active()
        with tr.span("lm.block"):
            pass
        tr.counter("attn.chunked.pairs", 4.0)
        tr.counter("attn.chunked.visible_pairs", 3.0)
    run = make_run("tokens", None)
    run.trace = {"window_s": 10.0}
    assert bench_run.reader("attn_chunked_useful_pct.lm")(run) == 75.0
    assert [s["name"] for s in run.program["spans"]] == ["lm.block"]
    assert bench_run.reader("attn_chunked_useful_pct.lm")(run) == 75.0
    assert obs_trace.take_profiled() is None


def _cells():
    return [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", _cells())
def test_traced_run_reports_every_new_metric(card, workload):
    code = (
        "import json, sys; sys.path[:0] = ['.', 'src']\n"
        "from portbench import run as R\n"
        "R.prepare()\n"
        "import torch\n"
        "from portbench.lib import cell, program\n"
        "seen, read = [], program.program\n"
        "program.program = lambda run: seen.append(read(run)) or seen[-1]\n"
        "c = cell.load(sys.argv[1])\n"
        "torch.cuda.set_device(0)\n"
        "dev = torch.device('cuda', 0)\n"
        "res, _ = R.run_cell(c, 2147483777, 2, True, dev)\n"
        "d = seen[-1]\n"
        "print(json.dumps({'metrics': res['metrics'],\n"
        "    'correct': res['correct'],\n"
        "    'window_s': res['device']['window_s'],\n"
        "    'max_device_s': max(s['device_s'] or 0 for s in d['spans'])}))\n")
    out = subprocess.run([sys.executable, "-c", code, workload],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in BENCH["per_layer"]
            if workload in m.get("workloads", [workload])}
    assert want <= set(got["metrics"]), want - set(got["metrics"])
    assert got["correct"]
    assert 0 < got["max_device_s"] <= got["window_s"]
