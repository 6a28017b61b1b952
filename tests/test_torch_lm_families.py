"""The port's dense and hybrid LM families on the CPU against the
reference: ``tinyllama-1.1b``, ``qwen3-8b`` (qk-norm), ``h2o-danube-3-4b``
(head width 120, sliding window) and ``recurrentgemma-2b`` (RG-LRU and
local attention blocks, head width 256, tied embeddings, logit softcap).

The configs match the reference's field for field, full and reduced.
At the reduced configs (f32, d 256) the reference's own parameters cross
through numpy and ``convert.params_from_numpy``, and ``forward``,
``prefill`` (logits and every cache leaf), ``serve_step`` and
``lm_decode`` are held to the reference's at 1e-4 scaled error (max
|port - reference| / max |reference|). The prompts (80 tokens) are longer
than the reduced windows (64 and 32), so prefill keeps a ring of the
last positions and decode wraps it. The RG-LRU block alone is held to
the reference's at ``RGLRU_TOL``: its prefill scan sums in another order
than ``jax.lax.associative_scan``. The model path at the full head
widths (120, 256) runs on narrow configs. The attention kernel at those
widths is held against its plain version on the card by
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import rglru as jrglru, transformer as jtr
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import common, rglru, transformer

from test_torch_lm import _assert_trees_close, _np_tree, _scaled_err

NAMES = ["tinyllama-1.1b", "qwen3-8b", "h2o-danube-3-4b", "recurrentgemma-2b"]
TOL = 1e-4            # scaled error, f32, whole model
# RG-LRU alone, scaled, f32: the log-depth scan against the reference's
# associative scan (readings ~1e-6). With a near 1 (log a ~ -2e-4) the
# reference's beta = sqrt(1 - exp(2 log a)) cancels: one ulp of exp (XLA's
# and torch's differ by that) moves beta by ~1e-4 relative, and S 1000
# such terms sum into h (readings 1.3e-5 for y, 1.5e-5 for h; either
# scan is within 3e-6 of a float64 scan of the same gates).
RGLRU_TOL = 1e-5
RGLRU_NEAR_ONE_TOL = 5e-5
B, S, STEPS = 2, 80, 6
MAX_LEN = S + STEPS


def _tokens(vocab, seed=0, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(
        np.int32)


def _reference_run(jc, jp, toks):
    """The reference's forward, prefill (all positions and last only),
    caches, and ``STEPS`` greedy serve steps with their caches."""
    jt = jnp.asarray(toks)
    out = {"forward": np.asarray(jtr.forward(jp, jc, jt)[0])}
    out["prefill_last"] = np.asarray(
        jtr.prefill(jp, jc, jt, max_len=MAX_LEN, last_only=True)[0])
    logits, caches = jtr.prefill(jp, jc, jt, max_len=MAX_LEN)
    out["prefill"], out["caches"] = np.asarray(logits), _np_tree(caches)
    tok, steps = jnp.argmax(logits[:, -1], axis=-1), []
    for i in range(STEPS):
        logits, caches = jtr.serve_step(jp, jc, caches, tok, S + i)
        steps.append((np.asarray(tok), np.asarray(logits)))
        tok = jnp.argmax(logits, axis=-1)
    out["steps"], out["step_caches"] = steps, _np_tree(caches)
    return out


def _port_run(tc, params, toks):
    t = torch.as_tensor(toks)
    out = {"forward": transformer.forward(params, tc, t)[0]}
    out["prefill_last"] = transformer.prefill(params, tc, t, max_len=MAX_LEN,
                                              last_only=True)[0]
    out["prefill"], out["caches"] = transformer.prefill(params, tc, t,
                                                        max_len=MAX_LEN)
    return out


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    npp = _np_tree(jp)
    toks = _tokens(jc.vocab)
    return dataclasses.make_dataclass(
        "Pair", ["name", "tc", "params", "toks", "ref"])(
        name, tc, params_from_numpy(npp, "cpu"), toks,
        _reference_run(jc, jp, toks))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("reduce", [False, True])
def test_configs_match_reference(name, reduce):
    jc, tc = jget(name), tget(name)
    if reduce:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        got, want = getattr(tc, f.name), getattr(jc, f.name)
        if dataclasses.is_dataclass(want):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert tc.resolved_head_dim == jc.resolved_head_dim
    assert tc.padded_vocab == jc.padded_vocab


def test_forward_logits(pair):
    got = transformer.forward(pair.params, pair.tc,
                              torch.as_tensor(pair.toks))[0]
    assert _scaled_err(got, pair.ref["forward"]) <= TOL


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits(pair, last_only):
    logits, _ = transformer.prefill(pair.params, pair.tc,
                                    torch.as_tensor(pair.toks),
                                    max_len=MAX_LEN, last_only=last_only)
    want = pair.ref["prefill_last" if last_only else "prefill"]
    assert logits.shape == want.shape
    assert _scaled_err(logits, want) <= TOL


def test_prefill_caches(pair):
    _, caches = transformer.prefill(pair.params, pair.tc,
                                    torch.as_tensor(pair.toks),
                                    max_len=MAX_LEN)
    _assert_trees_close(caches, pair.ref["caches"])
    windowed = {"h2o-danube-3-4b": 64, "recurrentgemma-2b": 32}
    if pair.name in windowed:
        # the window's ring holds the last positions, not all S
        kpos = [leaf for leaf in jax.tree_util.tree_leaves(
            pair.ref["caches"]) if leaf.dtype == np.int32]
        assert any(k.shape[-1] == windowed[pair.name] for k in kpos)


def test_serve_step_logits_and_caches(pair):
    logits, caches = transformer.prefill(pair.params, pair.tc,
                                         torch.as_tensor(pair.toks),
                                         max_len=MAX_LEN)
    for i, (tok, want) in enumerate(pair.ref["steps"]):
        logits, caches = transformer.serve_step(
            pair.params, pair.tc, caches, torch.as_tensor(np.array(tok)),
            S + i)
        assert _scaled_err(logits, want) <= TOL, i
    _assert_trees_close(caches, pair.ref["step_caches"])


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_matches_reference(name):
    """Greedy tokens equal the reference's on the rows where every step's
    choice is decided by more than the logits' tolerance."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    seed, batch, prompt_len, gen = 3, 2, 70, 6
    want = np.asarray(jserve.lm_decode(jc, batch=batch, prompt_len=prompt_len,
                                       gen=gen, seed=seed)["generated"])
    params = params_from_numpy(
        _np_tree(jtr.init(jax.random.PRNGKey(seed), jc)), "cpu")
    res = tserve.lm_decode(tc, batch=batch, prompt_len=prompt_len, gen=gen,
                           seed=seed, params=params, device="cpu")
    got = res["generated"].numpy()
    assert got.shape == want.shape == (batch, gen)
    prompts = next(iter(tdata.lm_batches(tc.vocab, batch, prompt_len - 1, 1,
                                         seed)))
    logits, caches = transformer.prefill(params, tc, torch.as_tensor(prompts),
                                         max_len=prompt_len + gen,
                                         last_only=True)
    decided = np.ones(batch, bool)
    for i in range(gen):
        top = torch.topk(logits, 2, dim=-1).values
        decided &= (top[:, 0] - top[:, 1]).numpy() > TOL * float(
            logits.abs().max())
        assert np.array_equal(logits.argmax(-1).numpy(), got[:, i])
        if i < gen - 1:
            logits, caches = transformer.serve_step(
                params, tc, caches, torch.as_tensor(got[:, i]), prompt_len + i)
    assert decided.any()
    np.testing.assert_array_equal(got[decided], want[decided])


# ---------------------------------------------------------------------------
# The RG-LRU block alone
# ---------------------------------------------------------------------------

def _rglru_pair(seed=0, lam=None):
    jc, tc = jget("recurrentgemma-2b").reduced(), \
        tget("recurrentgemma-2b").reduced()
    jp = jrglru.init(jax.random.PRNGKey(seed), jc)
    if lam is not None:
        jp = dict(jp, **{"lambda": jnp.full_like(jp["lambda"], lam)})
    return jc, tc, jp, params_from_numpy(_np_tree(jp), "cpu")


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_reference(with_state):
    jc, tc, jp, tp = _rglru_pair()
    W = tc.rglru.lru_width
    x = _x((2, 50, tc.d_model))
    kw_j, kw_t = {}, {}
    if with_state:
        h0, conv0 = _x((2, W), seed=2), _x((2, 3, W), seed=3)
        kw_j = {"h0": jnp.asarray(h0), "conv0": jnp.asarray(conv0)}
        kw_t = {"h0": torch.as_tensor(h0), "conv0": torch.as_tensor(conv0)}
    want = jrglru.forward(jp, jc, jnp.asarray(x), **kw_j)
    got = rglru.forward(tp, tc, torch.as_tensor(x), **kw_t)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _scaled_err(g, w) <= RGLRU_TOL


def test_rglru_decode_step_matches_reference_in_place():
    jc, tc, jp, tp = _rglru_pair(seed=4)
    W = tc.rglru.lru_width
    h, conv = _x((3, W), seed=5), _x((3, 3, W), seed=6)
    x = _x((3, tc.d_model), seed=7)
    want_y, want_c = jrglru.decode_step(
        jp, jc, {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        jnp.asarray(x))
    cache = {"h": torch.as_tensor(h.copy()), "conv": torch.as_tensor(
        conv.copy())}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    y, out = rglru.decode_step(tp, tc, cache, torch.as_tensor(x))
    assert _scaled_err(y, want_y) <= RGLRU_TOL
    # the cache given is the cache returned, written in place
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k in ("h", "conv"):
        assert _scaled_err(cache[k], want_c[k]) <= RGLRU_TOL, k
    assert not np.allclose(cache["h"].numpy(), h)


def test_rglru_long_scan_with_a_near_one():
    """S 1000 with softplus(Lambda) ~ 4.5e-5, so a = exp(-8 softplus r)
    stays above 0.9996: the state carries across the whole sequence, and
    the two scans' summation orders differ over ~10 levels."""
    jc, tc, jp, tp = _rglru_pair(seed=8, lam=-10.0)
    x = _x((1, 1000, tc.d_model), seed=9)
    want_y, want_h, _ = jrglru.forward(jp, jc, jnp.asarray(x))
    got_y, got_h, _ = rglru.forward(tp, tc, torch.as_tensor(x))
    # a at its smallest (r = 1)
    assert float(torch.exp(-8 * common.softplus(tp["lambda"])).min()) > 0.9996
    assert _scaled_err(got_y, want_y) <= RGLRU_NEAR_ONE_TOL
    assert _scaled_err(got_h, want_h) <= RGLRU_NEAR_ONE_TOL
    # the scans alone, on the port's gates, against a float64 recurrence
    xb = torch.as_tensor(x) @ tp["x_branch"]
    a, b = rglru._gates(tp, rglru._causal_conv(xb, tp["conv_w"]))
    h, want = torch.zeros(a.shape[0], a.shape[2], dtype=torch.float64), []
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + b[:, t].double()
        want.append(h)
    assert _scaled_err(rglru.linear_scan(a, b), torch.stack(want, 1)) <= 5e-6


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(10)
    for S_ in (1, 2, 3, 7, 64, 100):
        a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, S_, 5)))
        b = torch.as_tensor(rng.standard_normal((2, S_, 5)))
        h, want = torch.zeros(2, 5, dtype=torch.float64), []
        for t in range(S_):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rglru.linear_scan(a, b),
                                   torch.stack(want, 1), rtol=1e-12,
                                   atol=1e-12)


def test_rglru_scan_differentiates():
    """LM training differentiates the trained block's plain forward: the
    scan's gradient reaches every RG-LRU parameter."""
    _, tc, _, tp = _rglru_pair(seed=11)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, h, _ = rglru.forward(leaves, tc, torch.as_tensor(
        _x((2, 40, tc.d_model), seed=12)))
    (y.square().mean() + h.square().mean()).backward()
    for k, v in leaves.items():
        assert v.grad is not None and bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().max()) > 0, k


# ---------------------------------------------------------------------------
# The full head widths on the model path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,hd", [("h2o-danube-3-4b", 120),
                                     ("recurrentgemma-2b", 256)])
def test_model_path_at_the_full_head_width(name, hd):
    """The reduced config at its published head width (d 256, 4 heads of
    120 or 256): prefill, its caches and decode against the reference."""
    jc = dataclasses.replace(jget(name).reduced(), head_dim=hd)
    tc = dataclasses.replace(tget(name).reduced(), head_dim=hd)
    assert tc.resolved_head_dim == hd
    jp = jtr.init(jax.random.PRNGKey(5), jc)
    params = params_from_numpy(_np_tree(jp), "cpu")
    toks = _tokens(jc.vocab, seed=13)
    ref = _reference_run(jc, jp, toks)
    got = _port_run(tc, params, toks)
    for key in ("forward", "prefill_last", "prefill"):
        assert _scaled_err(got[key], ref[key]) <= TOL, key
    _assert_trees_close(got["caches"], ref["caches"])
    caches = got["caches"]
    for i, (tok, want) in enumerate(ref["steps"]):
        logits, caches = transformer.serve_step(
            params, tc, caches, torch.as_tensor(np.array(tok)), S + i)
        assert _scaled_err(logits, want) <= TOL, i
    _assert_trees_close(caches, ref["step_caches"])
