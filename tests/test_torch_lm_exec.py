"""The port's joint FF step and backprop step on the CPU against the
reference (the reference's initial parameters and draws, a small
qwen2-0.5b: ``.reduced()``, 3 attention blocks, seq 16), and within the
port: ``LMExecutor`` bit-exact against ``train_chapters`` over the
reference's ``_LM_MATRIX`` (overlap on/off on ``_LM_AB_CASES``), the
facade's LM path and its errors, the unported block kinds, and the
repair that makes the attention and SSD kernels refuse autograd inputs
while the trainers route gradients through the plain versions.

Tolerances as ``tests/test_torch_lm_train.py`` states them."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import train as jtrain
from repro_torch import api as tapi, data as tdata, optim as toptim
from repro_torch.core import pff_exec, pff_lm, train as ttrain
from repro_torch.kernels import guard
from repro_torch.models import blocks, transformer

from test_torch_lm_train import (LOSS_TOL, N_BLOCKS, SEQ, _assert_params_close,
                                 _cfgs, _port, _rel, one_thread,
                                 setup)  # noqa: F401
from test_torch_train import JaxKey


@pytest.mark.parametrize("goodness,neg_mode", [
    ("sumsq", "random"), ("sumsq", "fixed"), ("sumsq", "adaptive"),
    ("perf_opt", "random")])
def test_joint_ff_step_matches_reference(setup, goodness, neg_mode):
    jc, tc = _cfgs(goodness=goodness, neg_mode=neg_mode)
    want_p, _, want_m = jtrain.make_ff_train_step(jc, lr=1e-3)(
        setup.jp, joptim.adam_init(setup.jp),
        {"tokens": jnp.asarray(setup.tok)}, 1)
    p0 = _port(setup.npp)
    got_p, _, got_m = ttrain.make_ff_train_step(tc, lr=1e-3, key_fn=JaxKey)(
        p0, toptim.adam_init(p0), {"tokens": torch.as_tensor(setup.tok)}, 1)
    assert set(got_m) == set(want_m)
    for name in want_m:
        assert abs(float(got_m[name]) - float(want_m[name])) <= \
            LOSS_TOL * max(abs(float(want_m[name])), 1.0), name
    _assert_params_close(got_p, want_p)


def test_bp_step_matches_reference(setup):
    want_p, _, want_m = jtrain.make_bp_train_step(setup.jc, lr=1e-3)(
        setup.jp, joptim.adam_init(setup.jp),
        {"tokens": jnp.asarray(setup.tok)}, 1)
    p0 = _port(setup.npp)
    got_p, _, got_m = ttrain.make_bp_train_step(setup.tc, lr=1e-3)(
        p0, toptim.adam_init(p0), {"tokens": torch.as_tensor(setup.tok)}, 1)
    assert _rel(got_m["loss_ce"], want_m["loss_ce"]) <= LOSS_TOL
    _assert_params_close(got_p, want_p)


# ---------------------------------------------------------------------------
# Within the port: the executor, the facade, the unported kinds
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("row", range(len(pff_exec._LM_MATRIX)))
def test_lm_executor_bit_exact_matrix(row, deterministic, capsys):
    failures = pff_exec._lm_check_case(
        *pff_exec._LM_MATRIX[row],
        check_overlap_ab=row in pff_exec._LM_AB_CASES, device="cpu")
    assert failures == [], failures
    assert "bit-exact" in capsys.readouterr().out


def test_lm_executor_counts_and_records(deterministic):
    tc, src = pff_exec._lm_case_setup(3, True)
    ex = pff_exec.LMExecutor(tc, src, "all_layers", 2, chapters=2,
                             steps_per_chapter=1, batch=2, device="cpu")
    res = ex.run(profile=True)
    assert [(r.kind, r.layer, r.chapter) for r in res.records] == [
        (kind, k, c) for c in range(2)
        for kind, k in [("train", 0), ("train", 1), ("train", 2),
                        ("head", 3)]]
    assert len(res.node_busy) == 2 and res.test_acc is None
    # chapter 1 runs on node 1: three block states and the head move
    assert res.handoff["prefetch_issued"] == 3 + 1 + 1
    with pytest.raises(ValueError, match="federated LM shards"):
        pff_exec.LMExecutor(tc, src, "federated", 2, chapters=1,
                            steps_per_chapter=1, device="cpu")


def test_fit_lm_facade(deterministic):
    tc, src = pff_exec._lm_case_setup(2, True)
    kw = dict(chapters=1, steps_per_chapter=1, batch=2, device="cpu")
    seq = tapi.fit(tc, src, **kw)
    assert seq.schedule == "sequential" and seq.records and seq.history
    assert np.isfinite(seq.eval_ce)
    ex = tapi.fit(tc, src, backend="executor", num_nodes=2, **kw)
    assert ex.schedule == "all_layers" and ex.eval_ce == seq.eval_ce
    assert pff_lm.lm_params_bit_equal(seq.params, ex.params)
    plain = tapi.fit(tc, src, impl="ref", **kw)
    assert pff_lm.lm_params_bit_equal(seq.params, plain.params)
    # the default source is the real-text BPE one
    dflt = tapi.fit(tc, None, seq=16, **kw)
    assert np.isfinite(dflt.eval_ce)
    for bad in (dict(resilience=tapi.ResilienceConfig()),
                dict(backend="executor", serve=tapi.ServeConfig())):
        with pytest.raises(ValueError, match="LM chapter schedules"):
            tapi.fit(tc, src, **{**kw, "backend": "executor", **bad})
    with pytest.raises(ValueError, match="sequential / executor"):
        tapi.fit(tc, src, backend="simulate", **kw)
    with pytest.raises(ValueError, match="kernel_impl"):
        from repro_torch.configs.ff_mlp import FFMLPConfig
        tapi.fit(FFMLPConfig(layer_sizes=(784, 8)), None, impl="ref",
                 device="cpu")


@pytest.mark.parametrize("field", ["moe", "enc_dec"])
def test_unported_lm_kinds_name_their_slice(field):
    """An encoder-decoder config names its slice; MoE configs are
    ported, so every trainer builds for the reduced deepseek-moe-16b."""
    makers = (ttrain.make_ff_train_step, ttrain.make_bp_train_step,
              pff_lm.make_block_step, pff_lm.make_head_step)
    if field == "moe":
        from repro_torch.configs import get_config
        tc = get_config("deepseek-moe-16b").reduced()
        for make in makers:
            assert callable(make(tc))
        return
    _, tc = _cfgs()
    tc = dataclasses.replace(tc, enc_dec=True)
    for make in makers:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make(tc)


# ---------------------------------------------------------------------------
# The repair: the kernels refuse autograd inputs; the plain route trains
# ---------------------------------------------------------------------------

def test_guard_decides_on_grad_mode_and_requires_grad():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    assert guard.records_grad(b, a)
    assert not guard.records_grad(b, b)
    with torch.no_grad():
        assert not guard.records_grad(a)
        guard.refuse_autograd("op", a)            # nothing recorded: fine
    with torch.inference_mode():
        assert not guard.records_grad(b)
    with pytest.raises(RuntimeError, match='impl="ref"'):
        guard.refuse_autograd("flash_attention", b, a)
    guard.refuse_autograd("mamba2_ssd", b, b)


@pytest.mark.parametrize("name,leaves", [
    ("qwen2-0.5b", ("wq", "wk", "wv")),
    ("mamba2-780m", ("A_log", "dt_bias", "in_proj"))])
@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_block_grads_reach_through_attention_and_scan(name, leaves, impl):
    """block_apply through the plain route under autograd gives non-zero
    grads to the params that reach the loss only through the attention or
    the scan (on the CPU "auto" is the plain route too)."""
    _, tc = _cfgs(name, n_blocks=1)
    kind = tc.groups[0][0][0]
    p = blocks.block_init(torch.Generator().manual_seed(0), tc, kind)
    sub = p["attn"] if kind == "attn" else p["ssm"]
    for n in leaves:
        sub[n].requires_grad_()
    x = torch.randn(2, 40, tc.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y, _ = blocks.block_apply(p, tc, kind, x, {"causal": True,
                                                "impl": impl})
    gs = torch.autograd.grad(torch.sum(torch.square(y - x)),
                             [sub[n] for n in leaves])
    for n, g in zip(leaves, gs):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, n


def test_trainers_route_grads_plain_and_frozen_forwards_by_impl(monkeypatch):
    """The trained block's forward asks for impl="ref"; the frozen prefix
    and the head task's forward for the step maker's impl, under
    no_grad."""
    seen = []
    real = blocks.block_apply

    def spy(p, cfg, kind, x, ctx):
        seen.append((ctx["impl"], torch.is_grad_enabled()))
        return real(p, cfg, kind, x, ctx)

    monkeypatch.setattr(blocks, "block_apply", spy)
    _, tc = _cfgs()
    p = transformer.init(torch.Generator().manual_seed(0), tc)
    tok = torch.as_tensor(tdata.text_source(512, SEQ, 0).blocks(
        "train", 2, seed=0))
    pff_lm.make_block_step(tc, impl="auto")(p, toptim.adam_init(p),
                                            {"tokens": tok}, 2, 1)
    assert seen == [("auto", False)] * 2 + [("ref", True)]
    seen.clear()
    pff_lm.make_head_step(tc, impl="auto")(p, toptim.adam_init(p),
                                           {"tokens": tok}, 1)
    assert seen == [("auto", False)] * N_BLOCKS
