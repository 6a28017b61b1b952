"""The readers this benchmark's MLA + MoE cell and its four-card cell
add give hand-computed values on hand-built runs and None where there
is nothing to read; the yardstick of the MLA + MoE chapter by hand; and
the new reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import run as bench_run  # noqa: E402
from portbench.lib import yardstick as ys  # noqa: E402
from portbench.lib import yardstick_mla_moe as ym  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MOON = json.loads((ROOT / "portbench" / "configs"
                   / "moonlight-16b-a3b.json").read_text())
MLP = json.loads((ROOT / "portbench" / "configs"
                  / "paper-mlp.json").read_text())
FOUR = json.loads((ROOT / "portbench" / "traffic"
                   / "full-batch.all-layers.4chip.json").read_text())


def span(name, device_s, sid):
    return {"name": name, "t0": 0.0, "t1": 0.0, "thread": "MainThread",
            "attrs": {}, "id": sid, "parent": None, "device_s": device_s}


def make_run(unit, program, cell=None, chapters=1, window_s=10.0):
    run = bench_run.Run(cell=cell or {}, unit=unit, work=0.0,
                        chapters=chapters, window_s=window_s, setup_s=0.0,
                        peak_bytes=0, spans=[], trace=None)
    run.program = program
    return run


PROGRAM = {"meta": {}, "events": [],
           "counters": {"moe.pairs": 400.0, "moe.rows": 410.0},
           "spans": [span(n, t, i) for i, (n, t) in enumerate([
               ("moe.router", 0.1), ("moe.dispatch", 0.2),
               ("moe.experts", 0.4), ("moe.combine", 0.3),
               ("moe.shared", 0.5), ("moe.bwd", 1.0),
               ("moe.bias_update", 0.01), ("lm.block.fwd", 9.0)])]}
BY_HAND = [
    ("moe_pct.lm", 100.0 * 2.51 / 10.0),
    ("moe_dispatch_pct.lm", 100.0 * 0.6 / 10.0),
    ("moe_padding_pct.lm", 100.0 * (410.0 / 400.0 - 1.0)),
]


@pytest.mark.parametrize("name,want", BY_HAND, ids=[c[0] for c in BY_HAND])
def test_reader_by_hand(name, want):
    assert bench_run.reader(name)(make_run("tokens", PROGRAM)) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [c[0] for c in BY_HAND])
def test_reader_gives_none_where_there_is_nothing_to_read(name):
    empty = {"meta": {}, "events": [], "counters": {}, "spans": []}
    assert bench_run.reader(name)(make_run("tokens", None)) is None
    assert bench_run.reader(name)(make_run("tokens", empty)) is None


def test_mfu_readers_read_only_their_own_cells():
    """mfu.mla_moe needs tokens and MLA's keys; mfu.mlp.4chip samples and
    an executor's chapters a call."""
    qwen = json.loads((ROOT / "portbench" / "configs"
                       / "qwen2-0.5b.json").read_text())
    t = {"batch": 4, "seq": 4096, "steps_per_chapter": 1}
    for config, unit in ((qwen, "tokens"), (MOON, "samples")):
        run = make_run(unit, None, {"config": config, "traffic": t,
                                    "chips": 1})
        assert bench_run.reader("mfu.mla_moe")(run) is None
    seq = json.loads((ROOT / "portbench" / "traffic"
                      / "full-batch.seq.json").read_text())
    for traffic, unit in ((seq, "samples"), (FOUR, "tokens")):
        run = make_run(unit, None, {"config": MLP, "traffic": traffic,
                                    "chips": 4})
        assert bench_run.reader("mfu.mlp.4chip")(run) is None


def test_every_new_metric_is_listed_for_its_cells_alone():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    for name, *_ in BY_HAND + [("mfu.mla_moe",)]:
        assert per[name]["workloads"] == ["moonlight-16b-a3b.chapters.s8192"]
    assert per["mfu.mlp.4chip"]["workloads"] == [
        "paper-mlp.full-batch.all-layers.4chip"]


def test_mla_moe_chapter_flops_by_hand():
    c = dict(MOON, hidden_size=8, num_attention_heads=2, kv_lora_rank=4,
             qk_nope_head_dim=2, qk_rope_head_dim=2, v_head_dim=2,
             intermediate_size=16, moe_intermediate_size=4,
             n_shared_experts=2, router_experts=8, n_routed_experts=2,
             num_experts_per_tok=4, num_hidden_layers=2, vocab_size=128)
    # one row of 3 tokens: causal pairs 1 + 2 + 3 = 6 a head
    proj = 8 * 2 * 4 + 8 * 6 + 4 * 2 * 4 + 2 * 2 * 8          # 192
    attn = 2 * 2 * 6 * (2 + 2 + 2)                            # 144
    dense = 2 * 3 * (proj + 3 * 8 * 16) + attn
    moe = 2 * 3 * (proj + 8 * 8 + 3 * 8 * 8 + 4 * 2 / 8 * 3 * 8 * 4) + attn
    assert ym.layer_flops(c, 1, 3, True) == dense
    assert ym.layer_flops(c, 1, 3, False) == pytest.approx(moe)
    b = [ym.layer_flops(c, 2, 3, j == 0) for j in range(2)]
    head = ym.layer_flops(c, 1, 3, True) + ym.layer_flops(c, 1, 3, False) \
        + 3 * 2 * 3 * 8 * 128
    assert ym.chapter_flops(c, 1, 3) == pytest.approx(
        3 * b[0] + b[0] + 3 * b[1] + head)


def test_mfu_readers_by_hand():
    cell = {"config": MOON, "chips": 1,
            "traffic": {"batch": 2, "seq": 8192, "steps_per_chapter": 1}}
    run = make_run("tokens", None, cell, chapters=3, window_s=7.0)
    want = 100.0 * 3 * ym.chapter_flops(MOON, 2, 8192) / 7.0 / 989e12
    assert bench_run.reader("mfu.mla_moe")(run) == pytest.approx(want)
    # the program's counters do not move it: the share is the even load's
    counted = {"meta": {}, "events": [], "spans": [],
               "counters": {"moe.pairs": 300.0, "moe.choices": 600.0}}
    run = make_run("tokens", counted, cell, chapters=3, window_s=7.0)
    assert bench_run.reader("mfu.mla_moe")(run) == pytest.approx(want)
    cell = {"config": MLP, "chips": 4, "traffic": FOUR}
    run = make_run("samples", None, cell, chapters=3, window_s=7.0)
    flops = ys.mlp_chapter_flops(MLP["layer_sizes"], 50000, 50000, 10, 1)
    want = 100.0 * flops * 3 * 4 / 7.0 / (4 * 495e12 / 3)
    assert bench_run.reader("mfu.mlp.4chip")(run) == pytest.approx(want)


def test_the_mla_moe_reference_loads_nothing_of_the_program():
    code = (f"import json, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import portbench.reference.mla_moe, portbench.lib.weights_mla_moe\n"
            "import portbench.lib.yardstick_mla_moe\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


# ---------------------------------------------------------------------------
# The four-card cell's driver, on four CPU nodes at a small size
# ---------------------------------------------------------------------------

SEED = 2 ** 31 + 23


def _small_exec_cell():
    from portbench.lib import cell as cell_lib

    cell = cell_lib.load("paper-mlp.full-batch.all-layers.4chip")
    cell["config"]["layer_sizes"] = [784, 96, 96, 96]
    cell["traffic"]["data"]["n_train"] = 400
    cell["traffic"]["batch"] = 400
    return cell


@pytest.fixture
def one_thread():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", ["sound", "prefetch_fault", "half_batch"])
def test_the_executor_cell_judges_the_windows_own_call(one_thread,
                                                       monkeypatch, case):
    """Set-up makes the window's call (every chapter of a call handed on
    inside one executor run), so a fault in the hand-off that only such
    a run makes, a prefetched copy of a layer's state that is not its
    producer's, reads not correct, as the half-batch control does."""
    import torch

    from portbench.drivers import ff_mlp_exec as drv
    from portbench.lib import compare
    from repro_torch.convert import tree_leaves
    from repro_torch.core import pff_exec

    bench_run.prepare()
    cell, dev = _small_exec_cell(), torch.device("cpu")
    if case == "prefetch_fault":
        prefetch = pff_exec._Handoff.prefetch

        def skewed(self, name, node, version, tree, *, src):
            prefetch(self, name, node, version, tree, src=src)
            slot = self.slots.get((name, node))
            if name[0] == "state" and slot is not None:
                tree_leaves(slot[1])[0].mul_(1.01)

        monkeypatch.setattr(pff_exec._Handoff, "prefetch", skewed)
    sess = drv.Session(cell, SEED, dev, [])
    readings, data = sess.readings, sess.data
    assert len(readings["labels"]) == cell["traffic"]["chapters_per_call"]
    if case == "half_batch":
        readings = drv.control_readings(cell, SEED, dev, readings, data,
                                        "half_batch")
    correct, _ = compare.judge(drv.check(cell, SEED, dev, readings, data),
                               cell["limits"])
    assert correct is (case == "sound")


def test_the_executor_cell_wants_a_card_a_node(monkeypatch):
    import torch

    from portbench.drivers import ff_mlp_exec as drv

    bench_run.prepare()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 nodes need 4 CUDA cards"):
        drv.Session(_small_exec_cell(), SEED, torch.device("cuda", 0), [])
