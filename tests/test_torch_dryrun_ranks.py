"""The per-rank dry run (``launch.dryrun.trace_combo`` with a mesh): one
rank's ``Dist`` step traced on fake tensors over a fake process group,
held against the same step run on real tensors by 4 gloo CPU ranks
(``torch_gloo_ranks dryrun``, a fresh interpreter that loads no jax),
each rank's run recorded by ``launch.op_analysis``: the collectives'
counts and bytes by type and the argument bytes are equal, the peak
within ``PEAK_TOL``, for the reduced qwen2-0.5b (dense) and
deepseek-moe-16b (MoE), train and prefill, on the (4 x 1) and (2 x 2)
(data, model) layouts: the dense config runs tensor-parallel on (2 x 2).
Then what the traces say against hand counts and against each other:
the dense train step all-reduces the grads of the leaves it holds whole
over "data" and reduce-scatters those it holds split (the gather's
transpose), and on (2 x 2) sums its heads' and ff's activations;
``batch_fold_model`` sums no activation and reduces each grad over
"model" too, and raises on a MoE config;
``causal_skip`` and ``pv_bf16`` trace; two ranks' counts agree; a batch
the batch axes do not divide stays whole on every rank; and no default
process group outlives a trace. The reference's GSPMD numbers are no
anchor here: its partitioner inserts collectives of its own.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.convert import tree_leaves
from repro_torch.launch import dryrun, specs
from repro_torch.models import transformer

import torch_gloo_ranks as gr

ROOT = pathlib.Path(__file__).resolve().parents[1]
PEAK_TOL = 0.01
AXES = ("data", "model")
CASES = [(layout, name, kind) for layout in gr.DRY_LAYOUTS
         for name in gr.DRY_CFGS for kind in gr.DRY_KINDS]


def _trace(name, kind, layout, rank=0, opts=(), shape=None):
    cfg = get_config(name).reduced()
    _, an, meta = dryrun.trace_combo(cfg, shape or gr.dry_shape(kind),
                                     mesh=dict(zip(AXES, layout)), rank=rank,
                                     opts=opts)
    assert not dist.is_initialized()
    return an, meta


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each gloo rank's analyses by (layout, config, kind); the fake
    traces' (analysis, meta) by (layout, config, kind, rank)), the fake
    traces made while the ranks run."""
    out = tmp_path_factory.mktemp("dryrun_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.Popen([sys.executable, "-m", "torch_gloo_ranks",
                             "dryrun", str(out)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        fake = {case + (rank,): _trace(case[1], case[2], case[0], rank)
                for case in CASES for rank in range(gr.WORLD)}
    finally:
        so, se = proc.communicate(timeout=600)
    assert proc.returncode == 0, so[-4000:] + se[-4000:]
    res = [torch.load(out / f"rank{r}.pt") for r in range(gr.WORLD)]
    assert all(r["leaked"] == [] for r in res)      # no rank loaded jax
    return res, fake


@pytest.mark.parametrize("layout,name,kind", CASES)
def test_fake_trace_equals_the_gloo_ranks(runs, layout, name, kind):
    for rank, res in enumerate(runs[0]):
        an, meta = runs[1][layout, name, kind, rank]
        want = res[layout, name, kind]
        assert meta["rank"] == rank and meta["chips"] == gr.WORLD
        assert an["collective_counts"] == want["collective_counts"], rank
        assert an["collective_by_type"] == want["collective_by_type"], rank
        got_m, want_m = an["memory"], want["memory"]
        assert got_m["argument_size_in_bytes"] \
            == want_m["argument_size_in_bytes"], rank
        assert abs(got_m["peak_size_in_bytes"]
                   - want_m["peak_size_in_bytes"]) \
            <= PEAK_TOL * want_m["peak_size_in_bytes"], rank


def test_the_cases_reach_every_collective_of_the_steps(runs):
    """The MoE's expert all-gathers and their reduce-scatters over
    "data" and, on (2 x 2), its all-to-alls over "model" (the sorted
    branch); the dense train step's all-reduces, its gathers of the
    leaves it holds split and their reduce-scatters, and no all-to-all;
    dense prefill's gathers, and on (2 x 2) the all-reduces of its
    tensor-parallel heads and ff, on (4 x 1) none."""
    res = runs[0][0]
    moe = res[(2, 2), "deepseek-moe-16b", "train"]["collective_counts"]
    assert all(moe[k] > 0 for k in ("all-reduce", "all-gather",
                                     "reduce-scatter", "all-to-all"))
    assert res[(2, 2), "deepseek-moe-16b", "prefill"][
        "collective_counts"]["all-to-all"] > 0
    assert res[(4, 1), "deepseek-moe-16b", "train"][
        "collective_counts"]["all-to-all"] == 0          # model axis 1
    dense = res[(2, 2), "qwen2-0.5b", "train"]["collective_counts"]
    assert all(dense[k] > 0 for k in ("all-reduce", "all-gather",
                                      "reduce-scatter"))
    assert dense["all-to-all"] == 0
    for layout in gr.DRY_LAYOUTS:
        pre = res[layout, "qwen2-0.5b", "prefill"]["collective_counts"]
        assert pre["all-gather"] > 0
        assert pre["reduce-scatter"] == pre["all-to-all"] == 0
        assert (pre["all-reduce"] > 0) == (layout[1] > 1)


def _held(cfg, layout):
    """(whole params as stand-ins, their held specs, each leaf's block
    bytes) of ``cfg`` on a (data, model) ``layout`` of sizes."""
    mesh = specs.SizesMesh(dict(zip(AXES, layout)))
    params, _ = specs.param_specs_abstract(cfg, with_opt=False)
    held = transformer.held_specs(params, cfg, dryrun.make_dist(cfg, mesh))
    coords = dict.fromkeys(AXES, 0)
    nbytes = [sharding.local_shard(t, sp, mesh, coords).numel()
              * t.element_size() for t, sp in zip(tree_leaves(params), held)]
    return params, held, nbytes


def _names(spec):
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


def _activation_sums(cfg, layout):
    """The dense FF step's all-reduces of activations a unit: on a
    model axis above 1, the attention's and the MLP's row-parallel
    outputs forward and their column-parallel inputs' cotangents
    backward, each the rank's (rows, S, d) f32; none else."""
    if layout[1] == 1:
        return 0, 0
    rows = 2 * gr.DRY_BATCH // layout[0]
    return 4, 4 * rows * gr.DRY_SEQ * cfg.d_model * 4


def _vocab_sums(cfg, layout):
    """The dense FF step's all-reduces over "model" of its
    vocab-parallel embedding and head, rank 0's (its rows the batch's
    positives): on a model axis above 1, the lookup's rows summed
    (rows, S, d) f32; the head CE's max, sum and label pick (rows, S)
    f32 each, once forward and once in its chunk's recompute; its
    features' cotangent (rows, S, d) f32; none else."""
    if layout[1] == 1:
        return 0, 0
    rows, S, d = 2 * gr.DRY_BATCH // layout[0], gr.DRY_SEQ, cfg.d_model
    return 8, 2 * rows * S * d * 4 + 6 * rows * S * 4


@pytest.mark.parametrize("layout", gr.DRY_LAYOUTS)
def test_dense_train_all_reduce_bytes_are_the_held_leaves(layout):
    """Every leaf of the dense config is held as the reference's rules
    split it, and trained. A leaf split over "data" is gathered where it
    is used, and its grad reduce-scattered back by the gather's
    transpose (the tied embedding twice: the embedding's loss and the
    head's; its vocab stays split over "model"); a leaf held whole over
    "data" has its grad all-reduced over it once a step, one bucket per
    unit and one for the head. On (2 x 2) each unit adds its
    tensor-parallel activation sums, and the embedding and head their
    vocab-parallel ones. The rank's arguments: its blocks of the params
    and Adam state and its rows of the batch."""
    cfg = get_config("qwen2-0.5b").reduced()
    params, held, nbytes = _held(cfg, layout)
    an, _ = _trace("qwen2-0.5b", "train", layout)
    units = sum(r for _, r in cfg.groups)
    n_act, act_bytes = _activation_sums(cfg, layout)
    n_voc, voc_bytes = _vocab_sums(cfg, layout)
    whole = sum(b for b, sp in zip(nbytes, held) if "data" not in _names(sp))
    split = sum(b for b, sp in zip(nbytes, held) if "data" in _names(sp))
    embed = nbytes[0]
    assert an["collective_by_type"]["all-reduce"] == \
        whole + units * act_bytes + voc_bytes
    assert an["collective_counts"]["all-reduce"] == \
        units + 1 + units * n_act + n_voc
    assert an["collective_by_type"]["reduce-scatter"] == split + embed
    assert an["memory"]["argument_size_in_bytes"] == 3 * sum(nbytes) + 4 * (
        gr.DRY_BATCH // layout[0] * (gr.DRY_SEQ + 1))   # params, m, v, rows


def test_batch_fold_model_adds_the_all_reduce_over_model():
    """With "model" folded into the batch axes no activation is summed
    (every rank runs its own rows through the gathered weights): a grad
    is all-reduced over each batch axis its leaf is held whole over, and
    reduce-scattered over each one it is split over. The prompts split
    over data x model. A MoE config raises."""
    cfg = get_config("qwen2-0.5b").reduced()
    _, held, nbytes = _held(cfg, (2, 2))
    fold, meta = _trace("qwen2-0.5b", "train", (2, 2),
                        opts=("batch_fold_model",))
    assert meta["opts"] == ["batch_fold_model"]
    want = sum(b * len({"data", "model"} - _names(sp))
               for b, sp in zip(nbytes, held))
    assert fold["collective_by_type"]["all-reduce"] == want
    # the tied embedding is gathered twice, over both axes
    uses = [2] + [1] * (len(held) - 1)
    assert fold["collective_counts"]["reduce-scatter"] == sum(
        u * len(_names(sp)) for u, sp in zip(uses, held))
    # the prompts split over data x model: a quarter of them on each rank
    pre, _ = _trace("qwen2-0.5b", "prefill", (2, 2))
    pre_fold, _ = _trace("qwen2-0.5b", "prefill", (2, 2),
                         opts=("batch_fold_model",))
    tok = 4 * gr.DRY_SEQ
    assert pre["memory"]["argument_size_in_bytes"] \
        - pre_fold["memory"]["argument_size_in_bytes"] == tok * (2 - 1)
    assert pre_fold["collective_counts"]["all-reduce"] == 0
    with pytest.raises(ValueError, match="batch_fold_model"):
        _trace("deepseek-moe-16b", "train", (2, 2),
               opts=("batch_fold_model",))


@pytest.mark.parametrize("opt", ["causal_skip", "pv_bf16"])
def test_unported_attention_options_raise(opt):
    """The chunked attention's options trace per rank (they reach the
    plain route's attention, ``tests/test_torch_chunked_attention.py``
    holds what they do) and are recorded; at this sequence (one chunk)
    they leave the dots and the collectives as they are. An unknown
    option still raises."""
    plain, _ = _trace("qwen2-0.5b", "prefill", (2, 2))
    an, meta = _trace("qwen2-0.5b", "prefill", (2, 2), opts=(opt,))
    assert meta["opts"] == [opt]
    assert an["flops"] == plain["flops"]
    assert an["collective_by_type"] == plain["collective_by_type"]
    with pytest.raises(ValueError, match="unknown option"):
        _trace("qwen2-0.5b", "prefill", (2, 2), opts=("fast",))


@pytest.mark.parametrize("name", gr.DRY_CFGS)
def test_ranks_0_and_3_report_equal_counts(name):
    """Their collectives and arguments agree; their work need not: the
    train step's head CE runs on the batch's positive rows, which are
    data rank 0's block alone, so its vocab-parallel sums over "model"
    carry rank 0's rows and none of rank 3's (the same collectives, of
    no bytes: the features' cotangent (rows, S, d) and the max, sum and
    pick (rows, S), forward and recomputed)."""
    cfg = get_config(name).reduced()
    rows = 2 * gr.DRY_BATCH // 2
    head = rows * gr.DRY_SEQ * (cfg.d_model + 6) * 4
    for kind in gr.DRY_KINDS:
        a, _ = _trace(name, kind, (2, 2), rank=0)
        b, _ = _trace(name, kind, (2, 2), rank=3)
        assert a["collective_counts"] == b["collective_counts"], kind
        want = dict(b["collective_by_type"])
        if kind == "train":
            want["all-reduce"] += head
        assert a["collective_by_type"] == want, kind
        assert a["memory"]["argument_size_in_bytes"] \
            == b["memory"]["argument_size_in_bytes"]
        if kind == "train":
            assert a["flops"] > b["flops"]
        else:
            assert a["flops"] == b["flops"]


def test_a_batch_the_axes_do_not_divide_stays_whole():
    """Decode at B 1 (as long_500k): every rank holds the whole batch of
    every cache, as one device does, and its half of the slots on model
    2 (``cache_specs_tree``'s seq_axis_model: the sequence, not the kv
    heads, splits at batch 1); at B 4 on (2 x 2) the caches and tokens
    are the rank's half of the batch too, and its kv heads half of
    qwen2's 2. The params are the rank's blocks either way."""
    cfg = get_config("qwen2-0.5b").reduced()
    _, _, nbytes = _held(cfg, (2, 2))
    p_bytes = sum(nbytes)
    R = sum(r for _, r in cfg.groups)
    kv = 2 * R * 64 * cfg.n_kv * cfg.resolved_head_dim * 4   # k, v per row
    kpos = 4 * 64 * R                                         # int32 (R, S)
    one = dataclasses.replace(INPUT_SHAPES["long_500k"], seq_len=64)
    ranked, _ = _trace("qwen2-0.5b", "decode", (2, 2), shape=one)
    assert ranked["memory"]["argument_size_in_bytes"] \
        == p_bytes + kv // 2 + kpos + 4
    four = dataclasses.replace(one, global_batch=4)
    ranked4, _ = _trace("qwen2-0.5b", "decode", (2, 2), shape=four)
    assert ranked4["memory"]["argument_size_in_bytes"] \
        == p_bytes + 4 * kv // 4 + kpos + 4 * 4 // 2


def test_no_default_group_outlives_a_trace():
    """After a trace, after one that raised inside the fake group (6
    train rows over 4 data ranks), and a group that already exists is
    refused, not joined, and left as it was."""
    _trace("qwen2-0.5b", "prefill", (4, 1))
    odd = dataclasses.replace(gr.dry_shape("train"), global_batch=3)
    with pytest.raises(ValueError, match="does not split"):
        _trace("qwen2-0.5b", "train", (4, 1), shape=odd)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            _trace("qwen2-0.5b", "prefill", (1, 1))
        assert dist.is_initialized() and dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_the_cli_prints_the_ranks_collectives(monkeypatch, capsys):
    """``--mesh pod1 --rank R --opts batch_fold_model`` at the reduced
    config: the record is the rank's, and its OK line names the
    collective bytes by type and whether the peak fits the card."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).reduced())
    (res, err), = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                               "--mesh", "pod1", "--rank", "17",
                               "--opts", "batch_fold_model"])
    assert err is None
    assert res["rank"] == 17 and res["opts"] == ["batch_fold_model"]
    assert res["per_device"] == "rank" and res["fits_hbm"]
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("OK   qwen2-0.5b__train_4k__pod1__rank17__"
                           "batch_fold_model:")
    assert "fits 80 GB: yes" in line and "all-reduce" in line
    assert not dist.is_initialized()
