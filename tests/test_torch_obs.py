"""The port's tracer (``repro_torch.obs``) on the CPU: the active tracer
and its installation, parent links and self time, the profiler mirror
and the clock anchor, the exporters' new fields, and the spans and
counters that the chapter tasks record, which change no result."""
import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import tracemalloc

import pytest
import torch

from repro_torch import api, configs, data, optim
from repro_torch.configs.ff_mlp import FFMLPConfig
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import ff_mlp, pff, pff_lm, strategies
from repro_torch.core.rng import TorchKey
from repro_torch.models import attention, transformer
from repro_torch.obs import analyze, export, trace as obs_trace

SEQ = 32         # tokens of SEQ + 1: SEQ inputs a row


def _names(d):
    return [s["name"] for s in d["spans"]]


def _by_name(d, name):
    return [s for s in d["spans"] if s["name"] == name]


def _parent_name(d, s):
    ids = {x["id"]: x for x in d["spans"]}
    p = ids.get(s["parent"])
    return None if p is None else p["name"]


# -- the active tracer -------------------------------------------------------

def test_active_is_noop_by_default_and_use_nests_and_restores():
    assert obs_trace.active() is obs_trace.NOOP
    a, b = obs_trace.Tracer(), obs_trace.Tracer()
    with obs_trace.use(a):
        assert obs_trace.active() is a
        with obs_trace.use(b):
            assert obs_trace.active() is b
        assert obs_trace.active() is a
        with pytest.raises(RuntimeError), obs_trace.use(b):
            raise RuntimeError("restored on the way out")
        assert obs_trace.active() is a
    assert obs_trace.active() is obs_trace.NOOP


def test_use_is_seen_by_every_thread():
    tr, seen = obs_trace.Tracer(), []
    with obs_trace.use(tr):
        t = threading.Thread(target=lambda: seen.append(obs_trace.active()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [tr]


def _tiny_lm():
    cfg = configs.get_config("qwen2-0.5b").reduced(d_model=64)
    cfg = dataclasses.replace(cfg, num_layers=3, groups=((("attn",), 3),))
    params = transformer.init(torch.Generator().manual_seed(0), cfg)
    tok = torch.as_tensor(data.text_source(cfg.vocab, SEQ, 0).blocks(
        "train", 2, seed=0))
    return cfg, params, {"tokens": tok}


def test_noop_records_nothing_and_registers_no_hook(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    cfg, params, batch = _tiny_lm()
    opt = optim.adam_init(params)
    pff_lm.make_block_step(cfg)(params, opt, batch, 1, 1)
    pff_lm.make_head_step(cfg)(params, opt, batch, 1)
    noop = obs_trace.NOOP
    assert noop.spans == [] and noop.events == [] and noop.counters == {}
    assert noop.span("x", device=torch.device("cpu")) is noop.span("y")


def test_noop_span_keeps_no_memory():
    noop = obs_trace.NOOP
    dev = torch.device("cpu")
    for _ in range(100):          # warm every code path first
        with noop.span("lm.block", device=dev):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10000):
            with noop.span("lm.block", device=dev):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [tracemalloc.Filter(True, obs_trace.__file__)]
    grown = sum(s.size_diff for s in after.filter_traces(here).compare_to(
        before.filter_traces(here), "filename"))
    assert grown <= 0


# -- parents, self time, device time, threads --------------------------------

def test_parent_ids_and_self_time():
    tr = obs_trace.Tracer()
    with tr.span("outer"):
        with tr.span("a"):
            pass
        h = tr.start("hooked", parent=tr.current(), push=False)
        with tr.span("b", device=torch.device("cpu")):
            pass
        tr.stop(h)
    d = tr.to_dict()
    ids = {s["name"]: s for s in d["spans"]}
    outer = ids["outer"]
    assert outer["parent"] is None
    assert {ids[n]["parent"] for n in ("a", "b", "hooked")} == {outer["id"]}
    assert len({s["id"] for s in d["spans"]}) == 4
    # a span that does not push is nobody's parent
    assert ids["b"]["parent"] == outer["id"]
    self_host = analyze.self_s(d)
    children = [(ids[n]["t0"], ids[n]["t1"]) for n in ("a", "hooked", "b")]
    covered = (children[0][1] - children[0][0]) + (
        max(c[1] for c in children[1:]) - min(c[0] for c in children[1:]))
    assert self_host[outer["id"]] == pytest.approx(
        outer["t1"] - outer["t0"] - covered, abs=1e-9)
    assert 0 <= self_host[outer["id"]] <= outer["t1"] - outer["t0"]
    assert self_host[ids["a"]["id"]] == pytest.approx(
        ids["a"]["t1"] - ids["a"]["t0"])
    # on the CPU no span has a device time
    assert all(s["device_s"] is None for s in d["spans"])
    assert set(analyze.self_s(d, device=True).values()) == {None}


def test_device_self_time_subtracts_the_children():
    d = {"spans": [
        {"name": "p", "t0": 0.0, "t1": 1.0, "id": 1, "parent": None,
         "device_s": 0.9},
        {"name": "c", "t0": 0.1, "t1": 0.2, "id": 2, "parent": 1,
         "device_s": 0.25},
        {"name": "c", "t0": 0.3, "t1": 0.4, "id": 3, "parent": 1,
         "device_s": None}]}
    assert analyze.self_s(d, device=True) == {1: pytest.approx(0.65),
                                              2: 0.25, 3: None}


def test_current_names_another_threads_innermost_open_span():
    tr = obs_trace.Tracer()
    ready, done, seen = threading.Event(), threading.Event(), []

    def work():
        with tr.span("worker.outer"), tr.span("worker.inner"):
            ready.set()
            done.wait(timeout=10)

    t = threading.Thread(target=work)
    t.start()
    assert ready.wait(timeout=10)
    with tr.span("main"):
        seen.append(tr.current(t.ident))
        seen.append(tr.current())
    done.set()
    t.join(timeout=10)
    assert not t.is_alive()
    ids = {s["name"]: s["id"] for s in tr.to_dict()["spans"]}
    assert seen == [ids["worker.inner"], ids["main"]]
    assert tr.current(t.ident) is None


# -- the profiler mirror and the clock anchor --------------------------------

def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def _one_span():
    with obs_trace.Tracer().span("warm-up"):
        pass


def test_profiler_mirror_and_anchor_share_one_clock():
    # a process's first record_function lags its recorded start by up to
    # a millisecond (set-up after the profiler's timestamp); one span on
    # a tracer of its own takes that out of the comparison
    _profiled(_one_span)
    tr = obs_trace.Tracer()

    def work():
        with obs_trace.use(tr):
            for _ in range(3):
                with tr.span("lm.block"):
                    with tr.span("lm.prefix"):
                        torch.ones(64, 64) @ torch.ones(64, 64)

    raw = _profiled(work)
    base_us = raw["baseTimeNanoseconds"] * 1e-3
    d = tr.to_dict()
    assert "clock_anchor" in d["meta"]
    for name in ("lm.block", "lm.prefix"):
        mirrors = sorted((e for e in raw["traceEvents"]
                          if e.get("name") == name
                          and e.get("cat") == "user_annotation"),
                         key=lambda e: e["ts"])
        mine = sorted(_by_name(d, name), key=lambda s: s["t0"])
        assert len(mirrors) == len(mine) == 3
        for s, e in zip(mine, mirrors):
            assert abs(obs_trace.wall_us(d, s["t0"])
                       - (e["ts"] + base_us)) < 200
            assert abs(obs_trace.wall_us(d, s["t1"])
                       - (e["ts"] + e["dur"] + base_us)) < 200


def test_no_mirror_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a mirror with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = obs_trace.Tracer()
    with tr.span("lm.block"):
        pass
    assert _names(tr.to_dict()) == ["lm.block"]


def test_a_profiled_run_records_into_the_profiler_bound_tracer():
    obs_trace.take_profiled()
    cfg, params, batch = _tiny_lm()
    opt = optim.adam_init(params)
    step = pff_lm.make_block_step(cfg)
    _profiled(lambda: step(params, opt, batch, 1, 1))
    assert obs_trace.active() is obs_trace.NOOP
    d = obs_trace.take_profiled()
    assert d["meta"]["source"] == "torch.profiler"
    assert _names(d).count("lm.block") == 1
    assert obs_trace.take_profiled() is None
    # an installed tracer takes precedence over the profiler-bound one
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        _profiled(lambda: step(params, opt, batch, 1, 2))
    assert obs_trace.take_profiled() is None
    assert _names(tr.to_dict()).count("lm.block") == 1


def test_the_profiler_bound_tracer_holds_one_session():
    """An undrained session's spans are dropped when a hot path has seen
    the profiler stopped and the next session records."""
    obs_trace.take_profiled()

    def one(name):
        with obs_trace.active().span(name):
            pass

    _profiled(lambda: one("first"))
    one("between")                  # outside the profiler: recorded nowhere
    _profiled(lambda: one("second"))
    assert _names(obs_trace.take_profiled()) == ["second"]
    # without a hot path between them, two sessions share one tracer
    _profiled(lambda: one("a"))
    _profiled(lambda: one("b"))
    assert _names(obs_trace.take_profiled()) == ["a", "b"]


def test_a_finished_session_stays_until_drained():
    """Hot paths after the session (a reference run before the readers)
    leave its spans for ``take_profiled``."""
    obs_trace.take_profiled()
    cfg, params, batch = _tiny_lm()
    opt = optim.adam_init(params)
    step = pff_lm.make_block_step(cfg)
    _profiled(lambda: step(params, opt, batch, 1, 1))
    step(params, opt, batch, 1, 2)
    d = obs_trace.take_profiled()
    assert _names(d).count("lm.block") == 1
    assert obs_trace.take_profiled() is None


# -- the exporters -----------------------------------------------------------

def _small_trace():
    tr = obs_trace.Tracer(meta={"run": "t"})
    with tr.span("task:train", kind="train", layer=0, chapter=0, node=0):
        with tr.span("mlp.layer", device=torch.device("cpu")):
            pass
    tr.event("mark", node=0)
    tr.counter("attn.chunked.pairs", 8.0)
    return tr


def test_chrome_export_puts_ts_on_the_profilers_base(tmp_path):
    tr = _small_trace()
    d = tr.to_dict()
    base = 1_700_000_000_000_000_000
    path = export.export(tr, str(tmp_path / "t.json"), format="chrome",
                         base_ns=base)
    doc = json.loads(open(path).read())
    assert doc["baseTimeNanoseconds"] == base
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    for s in d["spans"]:
        e = xs[s["name"]]
        assert e["ts"] + base * 1e-3 == pytest.approx(
            obs_trace.wall_us(d, s["t0"]), abs=1)
        assert (e["args"]["id"], e["args"]["parent"],
                e["args"]["device_s"]) == (s["id"], s["parent"],
                                           s["device_s"])
    assert xs["task:train"]["args"]["kind"] == "train"
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert inst[0]["ts"] + base * 1e-3 == pytest.approx(
        obs_trace.wall_us(d, d["events"][0]["t"]), abs=1)


def test_jsonl_round_trips_the_new_fields(tmp_path):
    d = _small_trace().to_dict()
    path = export.export(d, str(tmp_path / "t.jsonl"), format="jsonl")
    again = export.load_jsonl(path)
    assert again["spans"] == d["spans"] and again["meta"] == d["meta"]
    assert again["counters"] == d["counters"]
    assert {"id", "parent", "device_s"} <= set(again["spans"][0])


# -- the chapter tasks' spans ------------------------------------------------

def test_block_and_head_steps_emit_their_spans():
    cfg, params, batch = _tiny_lm()
    opt = optim.adam_init(params)
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        pff_lm.make_block_step(cfg)(params, opt, batch, 2, 1)
        pff_lm.make_head_step(cfg)(params, opt, batch, 1)
    d = tr.to_dict()
    blk = _by_name(d, "lm.block")
    assert len(blk) == 1 and blk[0]["parent"] is None
    assert blk[0]["attrs"] == {"block": 2}
    kids = sorted((s for s in d["spans"] if s["parent"] == blk[0]["id"]),
                  key=lambda s: s["t0"])
    assert [s["name"] for s in kids] == [
        "lm.negatives", "lm.prefix", "lm.block.fwd", "lm.block.bwd",
        "lm.adam"]
    # the prefix of block 2 runs two blocks through the chunked route
    # on the CPU; the trained block one forward and its backward
    fwd = _by_name(d, "attn.chunked.fwd")
    assert sorted(_parent_name(d, s) for s in fwd) == [
        "lm.block.fwd", "lm.head.prefix", "lm.head.prefix",
        "lm.head.prefix", "lm.prefix", "lm.prefix"]
    bwd = _by_name(d, "attn.chunked.bwd")
    assert len(bwd) == 1 and _parent_name(d, bwd[0]) == "lm.block.bwd"
    (lbwd,) = _by_name(d, "lm.block.bwd")
    assert lbwd["t0"] <= bwd[0]["t0"] <= bwd[0]["t1"] <= lbwd["t1"]
    head = _by_name(d, "lm.head")
    assert len(head) == 1 and head[0]["parent"] is None
    assert sorted(s["name"] for s in d["spans"]
                  if s["parent"] == head[0]["id"]) == [
        "lm.head.adam", "lm.head.ce", "lm.head.prefix"]
    assert all(s["device_s"] is None for s in d["spans"])
    # on the CPU's chunked route, one chunk of 32 x 32 pairs a row and
    # head, 528 of them under the causal mask: the prefix's two blocks
    # and the trained block over 2B rows (with the corruptions), the
    # head's three blocks over B
    rows = (2 + 1) * 2 * 2 + 3 * 2
    assert d["counters"] == {
        "attn.chunked.calls": len(fwd),
        "attn.chunked.pairs": rows * cfg.n_heads * 32 * 32,
        "attn.chunked.visible_pairs": rows * cfg.n_heads * 528}


def test_chunk_pairs_by_hand():
    # 4 x 4 causal: 16 pairs, 1 + 2 + 3 + 4 visible
    assert attention.chunk_pairs(4, 4, 4, 4, 0, 0, True, None, False) == \
        (16, 10)
    # window 2: 1 + 2 + 2 + 2
    assert attention.chunk_pairs(4, 4, 4, 4, 0, 0, True, 2, False) == \
        (16, 7)
    # q chunks of 2, k chunks of 2, causal_skip: k chunk 1 skips q
    # chunk 0, so 12 pairs are computed, the same 10 visible
    assert attention.chunk_pairs(4, 4, 2, 2, 0, 0, True, None, True) == \
        (12, 10)
    # a query 2 positions on (decode-like offsets), not causal: all pairs
    assert attention.chunk_pairs(2, 4, 2, 4, 2, 0, False, None, False) == \
        (8, 8)
    assert attention.chunk_pairs(2, 4, 2, 4, 2, 0, True, None, False) == \
        (8, 3 + 4)


def _mlp_setup():
    cfg = FFMLPConfig(layer_sizes=(784, 16, 16), epochs=2, splits=1,
                      batch_size=32, seed=0)
    task = data.mnist_like(seed=0, n_train=64, n_test=8)
    params = ff_mlp.init(cfg, TorchKey(0), "cpu")
    opt = ff_mlp.opt_init(params)
    x = torch.as_tensor(task.x_train)
    y = torch.as_tensor(task.y_train)
    xp = ff_mlp._norm(torch.cat([x[:, 10:] * 0, x[:, 10:]], 1)[:, :784])
    xn = ff_mlp._norm(x)
    return cfg, params, opt, x, y, xp, xn


def _layer_chapter(params, opt, xp, xn, cfg):
    lrs = torch.full((cfg.epochs,), 0.01)
    return ff_mlp.train_layer_chapter(
        params["layers"][0], opt["layers"][0], xp, xn, lrs,
        TorchKey(0).fold_in(3), batch=cfg.batch_size, epochs=cfg.epochs,
        theta=cfg.theta)


def test_layer_chapter_and_negatives_emit_the_mlp_spans():
    cfg, params, opt, x, y, xp, xn = _mlp_setup()
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        lp, _ = _layer_chapter(params, opt, xp, xn, cfg)
        with torch.no_grad():
            ff_mlp.fwd_norm(lp, xp)
            scores = pff._class_scores_chunked(params, x, cfg)
            strategies.negatives.get("adaptive").fn(
                TorchKey(1), cfg, params, x, y, scores)
    d = tr.to_dict()
    (layer,) = _by_name(d, "mlp.layer")
    # 2 epochs of 2 batches: a permutation an epoch, a grad and an
    # Adam step a batch, the forward inside each grad
    kids = [s["name"] for s in sorted(d["spans"], key=lambda s: s["t0"])
            if s["parent"] == layer["id"]]
    assert kids == ["mlp.perm", "mlp.grad", "mlp.adam", "mlp.grad",
                    "mlp.adam"] * 2
    assert all(_parent_name(d, s) == "mlp.grad"
               for s in _by_name(d, "mlp.fwd"))
    assert len(_by_name(d, "mlp.fwd")) == 4
    for name in ("mlp.layer", "mlp.fwd_norm", "mlp.neg.score",
                 "mlp.neg.draw"):
        assert [s["parent"] for s in _by_name(d, name)] == [None]


def test_schedule_tasks_nest_the_program_spans():
    cfg = FFMLPConfig(layer_sizes=(784, 16, 16), epochs=2, splits=2,
                      batch_size=32, seed=0)
    task = data.mnist_like(seed=0, n_train=64, n_test=8)
    tr = obs_trace.Tracer()
    res = api.fit(cfg, task, device="cpu", trace=tr)
    d = tr.to_dict()
    tasks = {s["id"]: s for s in d["spans"] if s["name"].startswith("task:")}
    assert sorted((s["attrs"]["kind"], s["attrs"]["layer"],
                   s["attrs"]["chapter"]) for s in tasks.values()) == sorted(
        (r.kind, r.layer, r.chapter) for r in res.records)
    for name in ("mlp.layer", "mlp.neg.score", "mlp.neg.draw"):
        spans = _by_name(d, name)
        assert spans and all(s["parent"] in tasks for s in spans)
    assert obs_trace.active() is obs_trace.NOOP


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("traced", ["installed", "profiled"])
def test_tracing_changes_no_lm_result(traced):
    cfg, params, batch = _tiny_lm()
    opt = optim.adam_init(params)
    runs = []
    for on in (False, True):
        p, o = _clone(params), _clone(opt)

        def steps():
            pff_lm.make_block_step(cfg)(p, o, batch, 2, 1)
            pff_lm.make_head_step(cfg)(p, o, batch, 1)

        if not on:
            steps()
        elif traced == "installed":
            with obs_trace.use(obs_trace.Tracer()):
                steps()
        else:
            _profiled(steps)
            assert obs_trace.take_profiled()["spans"]
        runs.append((p, o))
    assert _bit_equal(runs[0][0], runs[1][0])
    assert _bit_equal(runs[0][1], runs[1][1])


def test_tracing_changes_no_mlp_result():
    cfg, params, opt, x, y, xp, xn = _mlp_setup()
    runs = []
    for on in (False, True):
        p, o = _clone(params), _clone(opt)
        with (obs_trace.use(obs_trace.Tracer()) if on
              else contextlib.nullcontext()):
            lp, lo = _layer_chapter(p, o, xp, xn, cfg)
        runs.append((lp, lo))
    assert _bit_equal(runs[0][0], runs[1][0])
    assert _bit_equal(runs[0][1], runs[1][1])
