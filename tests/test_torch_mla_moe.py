"""Moonlight-16B-A3B's block (MLA, a dense layer, DeepSeek-V3's
sigmoid-routed MoE on a card's share of the experts) against the plain
reference of the benchmark (``portbench/reference/mla_moe.py``), on
seeded random weights at reduced widths in float32 on the CPU; the
registered config against the published one; and what the port refuses
for it (serving, ``Dist``, the dry run, the pod pipeline)."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]

from portbench.drivers import mla_moe_chapters as drv  # noqa: E402
from portbench.lib import weights_mla_moe as wm  # noqa: E402
from portbench.reference import mla_moe as ref  # noqa: E402
from repro_torch import api, optim  # noqa: E402
from repro_torch.configs import (MLAConfig, get_config,  # noqa
                                 list_configs, port_only, reference_names)
from repro_torch.core import pff_lm  # noqa: E402
from repro_torch.core.rng import TorchKey  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import attention, blocks, mla, mlp  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

NAME = "moonlight-16b-a3b"
PUBLISHED = json.loads((ROOT / "portbench" / "configs"
                        / f"{NAME}.json").read_text())
# the benchmark file's keys at reduced widths, every expert held
SMALL = dict(PUBLISHED, hidden_size=64, num_attention_heads=4,
             intermediate_size=96, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16, moe_intermediate_size=32,
             n_routed_experts=8, router_experts=8, num_experts_per_tok=3,
             vocab_size=256, num_hidden_layers=3, dtype="float32",
             expert_offset=0)


def _cfg(c=SMALL):
    """The port's config for a benchmark-style dict ``c``."""
    base = get_config(NAME)
    return dataclasses.replace(
        base, d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_attention_heads"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], dtype=c["dtype"],
        num_layers=c["num_hidden_layers"],
        groups=((("mla_dense",), 1), (("mla_moe",),
                                       c["num_hidden_layers"] - 1)),
        mla=MLAConfig(c["kv_lora_rank"], c["qk_nope_head_dim"],
                      c["qk_rope_head_dim"], c["v_head_dim"]),
        moe=dataclasses.replace(
            base.moe, num_experts=c["router_experts"],
            top_k=c["num_experts_per_tok"],
            expert_ff=c["moe_intermediate_size"],
            experts_held=c["n_routed_experts"],
            expert_offset=c["expert_offset"]))


def _scaled_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(seed=0, c=SMALL, randomize_norms=True):
    w = wm.make(c, seed, "cpu")
    if randomize_norms:
        g = torch.Generator().manual_seed(seed + 1)
        for grp in ("dense", "moe"):
            for n in ("norm1", "norm2", "kv_norm", "bias"):
                if n not in w[grp]:
                    continue
                t = w[grp][n]
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return w


def _x(B=2, S=48, d=64, seed=5):
    return torch.randn(B, S, d, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------

def test_registered_config_is_the_published_one():
    """Every width of the published config.json, as the benchmark's file
    copies it, in the registered config; the cut keys aside."""
    c = get_config(NAME)
    p = PUBLISHED
    assert (c.num_layers, c.vocab, c.moe.num_experts) == (27, 163840, 64)
    assert c.groups == ((("mla_dense",), p["first_k_dense_replace"]),
                        (("mla_moe",), 27 - p["first_k_dense_replace"]))
    for key, path in drv.WIDTHS.items():
        v = c
        for attr in path:
            v = getattr(v, attr)
        assert v == p[key], key
    assert c.moe.shared_ff * c.moe.num_shared == 2816
    assert not c.tie_embeddings and c.mla.qk_head_dim == 192


def test_the_port_only_config_is_named_once_and_kept_apart():
    assert set(list_configs()) - set(reference_names()) == {NAME}
    assert port_only(get_config(NAME)) and port_only(
        get_config(NAME).reduced())
    assert not any(port_only(get_config(n)) for n in reference_names())


# ---------------------------------------------------------------------------
# MLA and the chunked route at dv != dqk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip", [False, True])
def test_chunked_route_takes_a_value_width_of_its_own(skip):
    g = torch.Generator().manual_seed(1)
    q, k = (torch.randn(2, 64, 4, 24, generator=g) for _ in range(2))
    v = torch.randn(2, 64, 4, 16, generator=g)
    got = attention.chunked_attention(q, k, v, causal=True, q_chunk=16,
                                      k_chunk=32, causal_skip=skip)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 24 ** -0.5
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert got.shape == (2, 64, 4, 16)
    assert _scaled_err(got, want) <= 2e-5


def _block_tree(w, j):
    return drv._group({n: t[None] for n, t in wm.unit(w, j).items()},
                      j)[0]


@pytest.mark.parametrize("j", [0, 1])
def test_block_outputs_match_the_reference(j):
    """The dense MLA block and the MoE block, forward, f32."""
    w, cfg, x = _weights(), _cfg(), _x()
    bp = transformer._layer(_block_tree(w, j), 0)
    kind = ("mla_dense", "mla_moe")[j]
    got, bal = blocks.block_apply(bp, cfg, kind, x, {"impl": "ref"})
    want, wbal, _ = ref.layer(ref.unit(w, j), SMALL, j, x, ref.Routes(None),
                              "f32")
    assert _scaled_err(got, want) <= 1e-5
    assert float(abs(bal - wbal)) <= 1e-6 * max(float(wbal), 1.0)
    q, k, v = mla.qkv(bp["attn"], cfg, x)
    assert q.shape[-1] == k.shape[-1] == 24 and v.shape[-1] == 16


def test_router_choices_are_the_references_and_weights_within_1e6():
    w, cfg = _weights(), _cfg()
    x = _x().reshape(-1, 64)
    bp = transformer._layer(_block_tree(w, 1), 0)
    wts, eids, bal, loads = mlp.sigmoid_router(bp["mlp"], x, cfg.moe, 2)
    _, chosen, rw = ref.route(ref.unit(w, 1), SMALL, x, ref.Routes(None),
                              "f32")
    assert torch.equal(eids, chosen)
    assert float((wts - rw).abs().max()) <= 1e-6
    assert float((wts.sum(-1) - SMALL["routed_scaling_factor"]).abs()
                 .max()) <= 1e-5
    assert torch.equal(loads, torch.bincount(chosen.reshape(-1),
                                             minlength=8).float())


# ---------------------------------------------------------------------------
# The MoE's dispatch: no drop, and a card's share of the experts
# ---------------------------------------------------------------------------

def test_no_pair_is_dropped_under_a_skewed_router():
    """Every token chooses the same three experts: each gets every token,
    4x an even share, and each pair is computed once."""
    w, cfg = _weights(), _cfg()
    bp = transformer._layer(_block_tree(w, 1), 0)
    bp["mlp"]["bias"] = torch.tensor([0., 0., 9., 0., 9., 0., 0., 9.])
    x = _x()
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        y, _, loads = mlp.sigmoid_moe_apply(bp["mlp"], x, cfg.moe, "silu")
    T = x.shape[0] * x.shape[1]
    c = tr.to_dict()["counters"]
    assert c["moe.pairs"] == c["moe.rows"] == c["moe.choices"] == 3 * T
    assert c["moe.max_load"] == T
    assert loads.tolist() == [0, 0, T, 0, T, 0, 0, T]
    want, _, _ = ref.moe(ref.unit(w, 1) | {"bias": bp["mlp"]["bias"]},
                         SMALL, x, ref.Routes(None), "f32")
    assert _scaled_err(y, want) <= 1e-5


def test_the_counters_show_a_dropped_pair(monkeypatch):
    """``moe.pairs`` counts the router's choices apart from the dispatch
    and ``moe.rows`` what the expert GEMMs took, so a dispatch that
    loses a pair reads one row short."""
    w, cfg = _weights(), _cfg()
    bp = transformer._layer(_block_tree(w, 1), 0)
    held = mlp._held_pairs

    def lossy(eids, moe):
        order, ends = held(eids, moe)
        return order, torch.cat([ends[:-1], ends[-1:] - 1])

    monkeypatch.setattr(mlp, "_held_pairs", lossy)
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        mlp.sigmoid_moe_apply(bp["mlp"], _x(), cfg.moe, "silu")
    c = tr.to_dict()["counters"]
    assert c["moe.rows"] == c["moe.pairs"] - 1


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards' shares of two experts each, the shared experts counted
    once, give the uncut eight-expert layer."""
    w, cfg, x = _weights(), _cfg(), _x()
    full = transformer._layer(_block_tree(w, 1), 0)["mlp"]
    whole, _, _ = ref.moe(ref.unit(w, 1), SMALL, x, ref.Routes(None), "f32")
    shared = mlp.dense_mlp_apply(full["shared"], x, "silu")
    total = shared.clone()
    for i in range(4):
        moe = dataclasses.replace(cfg.moe, experts_held=2, expert_offset=2 * i)
        part = {**full, **{n: full[n][2 * i:2 * i + 2]
                           for n in ("wi", "wg", "wo")}}
        y, _, _ = mlp.sigmoid_moe_apply(part, x, moe, "silu")
        total = total + (y - shared)
    assert _scaled_err(total, whole) <= 1e-5


# ---------------------------------------------------------------------------
# FF block steps against the reference
# ---------------------------------------------------------------------------

def _program(w, cfg):
    params = drv.program_tree(w)
    return params, optim.adam_init(params)


def test_block_steps_grads_weights_and_bias_match_the_reference():
    """Blocks 0 and 1 one grad step each (steps 1 and 2): each first
    gradient within 1e-4 scaled, both blocks' weights after step 2 (within
    the f32 summation-order limit), the router's bias bit for bit."""
    c = dict(SMALL, num_hidden_layers=2)
    cfg, seed = _cfg(c), 11
    w = _weights(seed, c)
    params, opt = _program(_weights(seed, c), cfg)
    step = pff_lm.make_block_step(cfg, lr=1e-3, seed=seed, key_fn=TorchKey,
                                  impl="ref")
    g = torch.Generator().manual_seed(3)
    batches = [torch.randint(0, 256, (2, 33), generator=g) for _ in range(2)]
    grads = {}
    for k, tokens in enumerate(batches):
        step(params, opt, {"tokens": tokens}, k, k + 1)
        for n, m in drv._unit(opt["m"], k).items():
            grads[n] = m / (1 - 0.9)
    out = ref.follow_blocks(w, c, batches, seed, 1e-3, None)
    for n, want in out["grad1"].items():
        assert _scaled_err(grads[n], want) <= 1e-4, n
    got = {**drv._unit(params, 0), **drv._unit(params, 1)}
    for n, want in out["params"].items():
        # the f32 summation-order limit (ROADMAP.md section 3, as
        # tests/test_torch_fit.py holds it): where a gradient cancels to
        # within rounding, Adam's normalized step moves a weight by up to
        # ~lr; so >= 99.99% of each leaf to 1e-4 and every element to 1e-3
        err = (got[n].double() - want.double()).abs() / want.abs().max()
        assert float((err <= 1e-4).double().mean()) >= 0.9999, n
        assert float(err.max()) <= 1e-3, n
    assert torch.equal(got["1.bias"], out["bias"]["1.bias"])
    assert not torch.equal(got["1.bias"], w["moe"]["bias"][0])


def test_a_traced_block_step_records_the_moe_spans_and_counters():
    c = dict(SMALL, num_hidden_layers=2)
    cfg = _cfg(c)
    params, opt = _program(_weights(0, c), cfg)
    step = pff_lm.make_block_step(cfg, lr=1e-3, seed=0, key_fn=TorchKey,
                                  impl="ref")
    tokens = torch.randint(0, 256, (2, 33),
                           generator=torch.Generator().manual_seed(4))
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        step(params, opt, {"tokens": tokens}, 1, 1)
    d = tr.to_dict()
    names = {s["name"] for s in d["spans"]}
    assert {"mla.proj", "attn.chunked.fwd", "attn.chunked.bwd",
            "moe.router", "moe.dispatch", "moe.experts", "moe.combine",
            "moe.shared", "moe.bwd", "moe.bias_update"} <= names
    # the prefix's MoE-free block and the trained MoE block: 4 rows x 32
    assert d["counters"]["moe.choices"] == 4 * 32 * 3
    assert d["counters"]["moe.pairs"] == d["counters"]["moe.rows"]


def test_chapters_train_through_fit_and_move_the_bias():
    cfg = get_config(NAME).reduced()
    res = api.fit(cfg, None, chapters=1, steps_per_chapter=1, batch=2,
                  seq=32, device="cpu")
    assert np.isfinite(res.eval_ce) and len(res.history) == 2
    assert res.params["groups"][1][0]["mlp"]["bias"].abs().sum() > 0


# ---------------------------------------------------------------------------
# What the port refuses for it
# ---------------------------------------------------------------------------

def _small_model():
    cfg = get_config(NAME).reduced()
    return cfg, transformer.init(torch.Generator().manual_seed(0), cfg)


def test_prefill_refuses_mla():
    cfg, params = _small_model()
    with pytest.raises(ValueError, match="latent"):
        transformer.prefill(params, cfg, torch.zeros(1, 8, dtype=torch.long))


def test_decode_refuses_mla():
    cfg, params = _small_model()
    with pytest.raises(ValueError, match="latent"):
        transformer.init_caches(cfg, 1, 16, device="cpu")
    bp = transformer._layer(params["groups"][0], 0)[0]
    with pytest.raises(ValueError, match="latent"):
        blocks.block_decode(bp, cfg, "mla_dense", {}, torch.zeros(1, 64), 0,
                            {})


def test_dist_refuses_mla():
    cfg, params = _small_model()
    with pytest.raises(ValueError, match="Dist"):
        dryrun.make_dist(cfg, {"data": 2, "model": 2})
    dist = mlp.Dist(mesh=object(), batch_axes=("data",), model_axis="model")
    bp = transformer._layer(params["groups"][0], 0)[0]
    with pytest.raises(ValueError, match="no Dist"):
        blocks.block_apply(bp, cfg, "mla_dense", _x(1, 8), {"dist": dist})


def test_the_dry_run_refuses_mla_and_leaves_it_out_of_all():
    with pytest.raises(ValueError, match="the dry run"):
        dryrun.analyze_combo(NAME, "train_4k")
    assert all(a != NAME for a, _ in dryrun.all_combos())


def test_pod1_refuses_mla():
    with pytest.raises(ValueError, match="mesh pod1"):
        dryrun.analyze_combo(NAME, "train_4k", mesh="pod1")
    with pytest.raises(ValueError, match="pod pipeline"):
        api.fit(get_config(NAME).reduced(), backend="pod", num_nodes=1,
                steps=1, batch=1, seq=8, device="cpu")
