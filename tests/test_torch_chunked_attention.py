"""The port's chunked attention route (``models.attention.chunked_attention``
on the plain impl) against the reference's ``repro.models.attention``
on the CPU: the route itself at small chunks (causal, windowed,
non-causal with Sq != Sk, offsets, GQA 4/2 and 8/1, a ragged length that
falls back to whole chunks) within 2e-5; ``causal_skip`` against the
reference's ``_triangle_attention``; ``pv_bf16`` against the reference
with its ``PV_BF16`` global set (monkeypatched for the test); the q, k
and v gradients against ``jax.grad``; reduced qwen2-0.5b and
recurrentgemma-2b ``forward`` at S 2048 with both options against the
reference's with both globals set; and the dry run: the options pass
``check_opts``, the op analyzer's dot flops of the route equal the
reference's compiled HLO's, and a reduced prefill's traced peak stays
below one dense score buffer. The reference runs under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import hlo_analysis
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.configs import INPUT_SHAPES, get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.models import attention, transformer

# the reference's chunked-attention test tolerance (f32), scaled by
# max |reference| below; 1e-4 scaled for what rounds through bf16 and for
# gradients and whole models
TOL = 2e-5
SCALED_TOL = 1e-4
# Whole models with pv_bf16: P and V round to bf16 at the same places in
# both packages, but P's f32 values differ in their last bits (the two
# libraries' exp and dot orders), so an element next to a bf16 rounding
# boundary rounds the other way in one of them: one bf16 step of that
# P. Over a reduced model's 2 layers at S 2048 that moves the logits by
# 5.4e-4 and 6.6e-4 of their max (qwen2-0.5b, recurrentgemma-2b), where
# the same flips move one attention call by ~1e-5.
PV_MODEL_TOL = 1e-3
# small chunks, so that S 256 has 8 q chunks and 4 k chunks
QC, KC = 32, 64

# (B, Sq, Sk, H, KV, hd, causal, window, q_offset)
CASES = {
    "causal": (2, 256, 256, 4, 2, 32, True, None, 0),
    "window48": (2, 256, 256, 4, 2, 32, True, 48, 0),
    "noncausal_sq_ne_sk": (2, 192, 256, 4, 2, 32, False, None, 0),
    "q_offset": (2, 128, 256, 4, 2, 32, True, None, 96),
    "gqa8_1": (2, 256, 256, 8, 1, 32, True, None, 0),
    "ragged": (2, 200, 200, 4, 2, 32, True, 48, 0),
}
SKIP_CASES = ["causal", "window48", "gqa8_1", "ragged",
              "noncausal_sq_ne_sk"]


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ref(q, k, v, **kw):
    return np.asarray(jax.jit(
        lambda q, k, v: jattn.chunked_attention(q, k, v, q_chunk=QC,
                                                k_chunk=KC, **kw))(q, k, v))


def _port(q, k, v, **kw):
    return attention.chunked_attention(
        *(torch.tensor(a) for a in (q, k, v)), q_chunk=QC, k_chunk=KC,
        impl="ref", **kw).numpy()


def _call(name, **kw):
    B, Sq, Sk, H, KV, hd, causal, window, q_off = CASES[name]
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=len(name))
    return (q, k, v), dict(causal=causal, window=window, q_offset=q_off,
                           **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_route_matches_the_reference(name):
    args, kw = _call(name)
    assert _err(_port(*args, **kw), _ref(*args, **kw)) <= TOL


@pytest.mark.parametrize("name", SKIP_CASES)
def test_causal_skip_matches_the_reference_triangle(name):
    args, kw = _call(name, causal_skip=True)
    want = _ref(*args, **kw)
    assert _err(_port(*args, **kw), want) <= TOL
    # and the skip changes nothing but rounding
    assert _err(_port(*args, **{**kw, "causal_skip": False}), want) <= TOL


def test_visible_q_chunks_are_the_reference_pairs():
    """k chunk j's q range is exactly the chunks the reference's
    ``_triangle_attention`` pairs with j (its pair list, rebuilt here
    from its two rules)."""
    for nq, nk, qc, kc in [(8, 4, 32, 64), (4, 2, 512, 1024),
                           (9, 1, 512, 4608), (64, 32, 512, 1024)]:
        for causal, window in [(True, None), (True, 48), (True, 4096),
                               (False, None), (False, 100)]:
            for j in range(nk):
                want = [i for i in range(nq)
                        if not (causal and j * kc > i * qc + qc - 1)
                        and not (window is not None
                                 and j * kc + kc - 1 <= i * qc - window)]
                lo, hi = attention.visible_q_chunks(j, nq, qc, kc, causal,
                                                    window)
                assert list(range(lo, hi)) == want


@pytest.mark.parametrize("name", ["causal", "window48", "q_offset"])
@pytest.mark.parametrize("skip", [False, True])
def test_pv_bf16_matches_the_reference(name, skip, monkeypatch):
    monkeypatch.setattr(jattn, "PV_BF16", True)
    args, kw = _call(name, causal_skip=skip)
    want = _ref(*args, **kw)
    got = _port(*args, pv_bf16=True, **kw)
    assert _err(got, want) <= SCALED_TOL
    # bf16 P and V move the output more than the route's rounding does
    assert _err(_port(*args, **kw), want) > 10 * _err(got, want)


@pytest.mark.parametrize("name", ["causal", "window48", "q_offset"])
@pytest.mark.parametrize("skip", [False, True])
def test_grads_match_the_reference(name, skip):
    (q, k, v), kw = _call(name, causal_skip=skip)
    ct = np.random.default_rng(7).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, q_chunk=QC, k_chunk=KC, **kw)
        return jnp.sum(out * ct)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = attention.chunked_attention(*leaves, q_chunk=QC, k_chunk=KC,
                                      impl="ref", **kw)
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(), leaves)
    for g, w, n in zip(got, want, "qkv"):
        assert _err(g.numpy(), w) <= SCALED_TOL, n


def test_route_choice():
    """The plain impl runs the chunked route at any offset; the kernel's
    impl is asked for at offsets 0 (it raises on a CPU tensor) and not
    with an offset."""
    q, k, v = (torch.tensor(a) for a in _inputs(1, 64, 64, 4, 2, 32))
    want = attention.chunked_attention(q, k, v, impl="ref")
    assert torch.equal(attention.chunked_attention(q, k, v), want)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        attention.chunked_attention(q, k, v, impl="cuda")
    got = attention.chunked_attention(q, k, v, impl="cuda", q_offset=1)
    assert torch.equal(got, attention.chunked_attention(q, k, v,
                                                        q_offset=1))


# ---------------------------------------------------------------------------
# Whole reduced models at S 2048: 4 q chunks and 2 k chunks of the
# reference's sizes, so causal_skip skips a pair in every attention layer
# ---------------------------------------------------------------------------

MODEL_S = 2048


def _ref_logits(jp, jc, toks, monkeypatch, pv_bf16):
    monkeypatch.setattr(jattn, "DEFAULT_CAUSAL_SKIP", True)
    monkeypatch.setattr(jattn, "PV_BF16", pv_bf16)
    return np.asarray(jax.jit(lambda p, t: jtr.forward(p, jc, t)[0])(
        jp, jnp.asarray(toks)))


def _port_logits(params, tc, toks, pv_bf16):
    with torch.no_grad():
        got, _ = transformer.forward(
            params, tc, torch.tensor(toks), impl="ref",
            attn_opts=attention.AttnOpts(causal_skip=True, pv_bf16=pv_bf16))
    assert got.dtype == torch.float32
    return got.numpy()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_reduced_forward_with_both_options(arch, monkeypatch):
    """causal_skip alone within 1e-4 of the reference's f32 logits; with
    pv_bf16 too, within PV_MODEL_TOL of the reference's with PV_BF16, and
    nearer to them than the port without pv_bf16 (2.6e-3 and 1.1e-3
    away: a reduced model's few attention layers, recurrentgemma's one
    of 32-key windows, show the option's bf16 rounding only a few times
    above the rounding flips)."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab, (1, MODEL_S)).astype(np.int32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    skip = _port_logits(params, tc, toks, False)
    assert _err(skip, _ref_logits(jp, jc, toks, monkeypatch, False)) \
        <= SCALED_TOL
    want = _ref_logits(jp, jc, toks, monkeypatch, True)
    got = _err(_port_logits(params, tc, toks, True), want)
    assert got <= PV_MODEL_TOL
    assert _err(skip, want) > got


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def test_check_opts_takes_both_options():
    cfg = tget("qwen2-0.5b")
    for sizes in ({}, {"data": 16, "model": 16}):
        dryrun.check_opts(cfg, ("causal_skip", "pv_bf16"), sizes)
    moe = tget("deepseek-moe-16b")
    dryrun.check_opts(moe, ("causal_skip", "pv_bf16"), {})
    with pytest.raises(ValueError, match="unknown option"):
        dryrun.check_opts(cfg, ("causal_skip", "fast"), {})
    with pytest.raises(ValueError, match="needs a mesh"):
        dryrun.check_opts(cfg, ("batch_fold_model",), {})
    assert dryrun.attn_opts(("pv_bf16",)) == attention.AttnOpts(
        causal_skip=False, pv_bf16=True)


def _hlo_flops(fn, *args):
    comp = jax.jit(fn).lower(*args).compile()
    return hlo_analysis.analyze(comp.as_text())["flops"]


@pytest.mark.parametrize("skip", [False, True])
def test_dot_flops_equal_the_reference_hlo(skip):
    """At (1, 2048, 4/2, 32) and the reference's chunk sizes: 8 pairs,
    6 of them visible under causal_skip."""
    B, S, H, KV, hd = 1, 2048, 4, 2, 32
    sd = jax.ShapeDtypeStruct
    want = _hlo_flops(
        lambda q, k, v: jattn.chunked_attention(q, k, v, causal_skip=skip),
        sd((B, S, H, hd), jnp.float32), sd((B, S, KV, hd), jnp.float32),
        sd((B, S, KV, hd), jnp.float32))
    with specs.new_mode():
        q = torch.empty(B, S, H, hd)
        k, v = torch.empty(B, S, KV, hd), torch.empty(B, S, KV, hd)
        got = op_analysis.analyze(
            lambda q, k, v: attention.chunked_attention(
                q, k, v, causal_skip=skip, impl="ref"), q, k, v)["flops"]
    pairs = 6 if skip else 8
    assert got == want == pairs * 2 * (2 * B * H * 512 * 1024 * hd)


def test_reduced_prefill_peak_below_one_dense_score_buffer():
    """One chunk's scores (half the dense buffer at 2 k chunks) at a
    time, P written over them; pv_bf16 adds P's bf16 copy (a quarter of
    the dense buffer) and no more."""
    cfg = tget("qwen2-0.5b").reduced()
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"],
                                seq_len=MODEL_S, global_batch=1)
    dense = 1 * cfg.n_heads * MODEL_S * MODEL_S * 4
    temp = {}
    for opts in [(), ("causal_skip",), ("causal_skip", "pv_bf16")]:
        _, an, meta = dryrun.trace_combo(cfg, shape, opts=opts)
        assert meta["opts"] == list(opts)
        temp[opts] = an["memory"]["temp_size_in_bytes"]
        if "pv_bf16" not in opts:
            assert an["memory"]["peak_size_in_bytes"] < dense
    assert temp[("causal_skip",)] == temp[()]
    assert temp[()] < temp[("causal_skip", "pv_bf16")] \
        <= temp[()] + dense // 4
