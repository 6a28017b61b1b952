"""The port's Mixture-of-Experts MLP and the two MoE configs,
``deepseek-moe-16b`` (MHA, 64 experts top-6, 2 shared) and
``qwen3-moe-235b-a22b`` (GQA, qk-norm, 128 experts top-8), on the CPU
against the reference.

The configs match the reference's field for field, full and reduced.
``moe_apply`` and its parts (the router's gates, expert ids and aux loss;
the sorted dispatch's buffer, ``valid`` mask and ``dest``) are held to
the reference's on the same numpy inputs and the reference's own
parameters, in both branches (dense-local at T <= 64 top_k, sorted
otherwise), with routing skewed onto one expert so that the sorted
branch drops, at the reduced sizes (4 experts, top-2) and at each
config's published expert count and top-k on narrow widths. f32 at
``TOL`` = 1e-4 scaled error (max |port - reference| / max |reference|),
bf16 at ``BF16_TOL``; expert ids, ``valid`` and ``dest`` exactly.

At the reduced configs the whole model (``forward`` logits and aux
loss, ``prefill`` logits and caches, serve steps, ``lm_decode`` tokens
on decided rows) is held to the reference's at ``TOL``, with one
prefill short enough (T 80 <= 128) to take the dense-local branch.
``block_apply`` returns the router's aux loss as the reference's does,
and one LM chapter of ``api.fit`` trains the reduced deepseek-moe-16b as
the reference's does."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi, data as jdata
from repro.configs import get_config as jget
from repro.configs.base import MoEConfig as JMoE
from repro.launch import serve as jserve
from repro.models import mlp as jmlp, transformer as jtr
from repro_torch import api as tapi, data as tdata
from repro_torch.configs import MoEConfig as TMoE, get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import pff_lm, train as ttrain
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks, mlp, transformer

from test_torch_lm import _assert_trees_close, _np_tree, _scaled_err
from test_torch_lm_families import MAX_LEN, S, STEPS, TOL, _tokens
from test_torch_lm_train import _assert_params_close
from test_torch_train import JaxKey

NAMES = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]
# bf16 experts and activations, f32 router: both sides round the expert
# products and the combine to bf16 at the same points; the two CPU GEMMs
# sum in other orders, so a product may land one bf16 step (2^-8
# relative) apart, and the residual adds a few such steps
BF16_TOL = 2e-2
SKEW = 4.0            # router column 0 along the tokens' shared offset

# the reference's functions under jit (one compile each, where eager
# dispatch compiles op by op): the same numerics, a fraction of the time
_jrouter = jax.jit(jmlp._router, static_argnums=2)
_jdispatch = jax.jit(jmlp._sorted_dispatch, static_argnums=(2, 3))
_jmoe = jax.jit(jmlp.moe_apply, static_argnums=(2, 3))
_jinit = jax.jit(jtr.init, static_argnums=1)
_jmoe_init = jax.jit(jmlp.moe_init, static_argnums=(1, 2, 3))
_jforward = jax.jit(jtr.forward, static_argnums=1)
_jprefill = jax.jit(jtr.prefill, static_argnums=1,
                    static_argnames=("max_len", "last_only"))
_jstep = jax.jit(jtr.serve_step, static_argnums=1)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: many small ops, which
    more threads only slow down under the test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_and_param_count_match_reference(name):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    want = jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0), jc))
    got = params_to_numpy(transformer.init(torch.Generator().manual_seed(0),
                                           tc))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(_np_tree(want)))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert (w.shape, w.dtype) == (g.shape, g.dtype)
    moe = got["groups"][0][0]["mlp"]
    assert moe["router"].dtype == np.float32
    # (repeat, E, d, ff): the expert axis after the group's repeat axis
    assert moe["wi"].shape == moe["wg"].shape == (1, 4, 256, 512)
    assert moe["wo"].shape == (1, 4, 512, 256)
    assert transformer.param_count(params_from_numpy(got, "cpu")) == \
        jtr.param_count(want)


def test_capacity_is_the_references():
    for T, k, E in [(8192, 6, 64), (8192, 8, 128), (160, 2, 4), (1, 2, 4),
                    (600, 6, 64), (7, 8, 128), (1000, 3, 7)]:
        assert mlp._capacity(T, k, E, 1.25) == jmlp._capacity(T, k, E, 1.25)
    # the card's prefill (B 4 x S 2048)
    assert mlp._capacity(8192, 6, 64, 1.25) == 960
    assert mlp._capacity(8192, 8, 128, 1.25) == 640


# ---------------------------------------------------------------------------
# moe_apply and its parts
# ---------------------------------------------------------------------------

# (E, top_k, d, expert_ff, num_shared, shared_ff): the reduced configs'
# MoE (both reduce to 4 experts top-2 at d 256), and the published
# expert counts and top-k at narrow widths
MOE_SIZES = {
    "reduced-shared": (4, 2, 256, 512, 1, 512),
    "reduced": (4, 2, 256, 512, 0, 0),
    "deepseek-E64k6": (64, 6, 64, 32, 2, 32),
    "qwen3moe-E128k8": (128, 8, 64, 32, 0, 0),
}


def _moe_case(size, T, skew, seed=0, dtype=jnp.float32):
    """The reference's MoE params (router column 0 along the tokens'
    shared offset when ``skew``) and tokens (T, d)."""
    E, k, d, ff, ns, sff = MOE_SIZES[size]
    kw = dict(num_experts=E, top_k=k, expert_ff=ff, num_shared=ns,
              shared_ff=sff)
    jm, tm = JMoE(**kw), TMoE(**kw)
    jp = _jmoe_init(jax.random.PRNGKey(seed), jm, d, dtype)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((T, d)).astype(np.float32)
    if skew:
        offset = rng.standard_normal(d).astype(np.float32)
        offset *= 2.0 / np.linalg.norm(offset)
        x += offset
        col = SKEW * offset / float(offset @ offset)
        jp = dict(jp, router=jp["router"].at[:, 0].set(jnp.asarray(col)))
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jm, tm, jp, params_from_numpy(_np_tree(jp), "cpu"), xj, xt


BRANCHES = {"dense-local": lambda k: 64 * k - 8,     # T <= 64 top_k
            "sorted": lambda k: 64 * k + 40}


@pytest.mark.parametrize("skew", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("size", list(MOE_SIZES))
def test_moe_apply_matches_reference(size, branch, skew):
    k = MOE_SIZES[size][1]
    T = BRANCHES[branch](k)
    jm, tm, jp, tp, xj, xt = _moe_case(size, T, skew)

    gate_j, eids_j, aux_j = _jrouter(jp, xj, jm)
    gate_t, eids_t, aux_t = mlp._router(tp, xt, tm)
    np.testing.assert_array_equal(eids_t.numpy(), np.asarray(eids_j))
    assert _scaled_err(gate_t, gate_j) <= TOL
    assert _scaled_err(aux_t, aux_j) <= TOL
    if skew:   # most tokens' first choice is expert 0
        assert float((eids_t[:, 0] == 0).float().mean()) > 0.75

    cap = mlp._capacity(T, k, tm.num_experts, tm.capacity_factor)
    buf_j, (si_j, dest_j, valid_j) = _jdispatch(xj, eids_j, jm.num_experts,
                                                cap)
    buf_t, (si_t, dest_t, valid_t) = mlp._sorted_dispatch(
        xt, eids_t, tm.num_experts, cap)
    np.testing.assert_array_equal(si_t.numpy(), np.asarray(si_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(dest_t.numpy(), np.asarray(dest_j))
    np.testing.assert_array_equal(buf_t.numpy(), np.asarray(buf_j))
    if skew:   # expert 0 overflows its capacity
        assert int((~valid_t).sum()) > 0

    y_j, a_j = _jmoe(jp, xj.reshape(2, T // 2, -1), jm, "silu")
    y_t, a_t = mlp.moe_apply(tp, xt.reshape(2, T // 2, -1), tm, "silu")
    assert tuple(y_t.shape) == y_j.shape
    assert _scaled_err(y_t, y_j) <= TOL
    assert _scaled_err(a_t, a_j) <= TOL
    # the branch taken is the one named: dense-local ignores capacity, so
    # a skewed routing that drops in the sorted branch changes nothing
    y_loc, _ = mlp._moe_local(tp, xt, tm, "silu")
    assert torch.equal(y_loc, y_t.reshape(T, -1))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_moe_apply_bf16_matches_reference(branch):
    k = MOE_SIZES["reduced-shared"][1]
    T = BRANCHES[branch](k)
    jm, tm, jp, tp, xj, xt = _moe_case("reduced-shared", T, True,
                                       dtype=jnp.bfloat16)
    assert tp["wi"].dtype == torch.bfloat16
    assert tp["router"].dtype == torch.float32
    _, eids_j, _ = _jrouter(jp, xj, jm)
    _, eids_t, _ = mlp._router(tp, xt, tm)
    np.testing.assert_array_equal(eids_t.numpy(), np.asarray(eids_j))
    y_j, a_j = _jmoe(jp, xj[None], jm, "silu")
    y_t, a_t = mlp.moe_apply(tp, xt[None], tm, "silu")
    assert y_t.dtype == torch.bfloat16
    assert _scaled_err(y_t.float(), np.asarray(y_j.astype(jnp.float32))) \
        <= BF16_TOL
    assert _scaled_err(a_t, a_j) <= TOL


def test_dense_local_runs_every_expert_and_weighs_by_the_gates():
    """Dense-local equals the sorted branch when nothing drops (the
    capacity covers every pair), on the same tokens."""
    _, tm, _, tp, _, xt = _moe_case("reduced-shared", 100, False)
    y_loc, a_loc = mlp._moe_local(tp, xt, tm, "silu")
    gate, eids, _ = mlp._router(tp, xt, tm)
    buf, meta = mlp._sorted_dispatch(xt, eids, tm.num_experts, 200)
    assert bool(meta[2].all())
    y_sorted = mlp._combine(mlp._expert_ffn(tp["wi"], tp["wg"], tp["wo"],
                                            buf, "silu"), meta, 100, 2, gate)
    y_sorted = y_sorted + mlp.dense_mlp_apply(tp["shared"], xt)
    assert _scaled_err(y_loc, y_sorted.numpy()) <= TOL


# ---------------------------------------------------------------------------
# Blocks and the whole model at the reduced configs
# ---------------------------------------------------------------------------

def _reference_run(jc, jp, toks):
    """The reference's forward (logits and aux), prefill (all positions
    and last only), caches, and ``STEPS`` greedy serve steps with their
    caches."""
    jt = jnp.asarray(toks)
    logits, aux = _jforward(jp, jc, jt)
    out = {"forward": np.asarray(logits), "aux": float(aux)}
    out["prefill_last"] = np.asarray(
        _jprefill(jp, jc, jt, max_len=MAX_LEN, last_only=True)[0])
    logits, caches = _jprefill(jp, jc, jt, max_len=MAX_LEN)
    out["prefill"], out["caches"] = np.asarray(logits), _np_tree(caches)
    tok, steps = jnp.argmax(logits[:, -1], axis=-1), []
    for i in range(STEPS):
        logits, caches = _jstep(jp, jc, caches, tok, jnp.int32(S + i))
        steps.append((np.asarray(tok), np.asarray(logits)))
        tok = jnp.argmax(logits, axis=-1)
    out["steps"], out["step_caches"] = steps, _np_tree(caches)
    return out


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    name = request.param
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = _jinit(jax.random.PRNGKey(0), jc)
    toks = _tokens(jc.vocab)
    ref = _reference_run(jc, jp, toks)
    return dataclasses.make_dataclass(
        "Pair", ["name", "jc", "tc", "jp", "params", "toks", "ref"])(
        name, jc, tc, jp, params_from_numpy(_np_tree(jp), "cpu"), toks, ref)


def test_block_apply_returns_the_router_aux(pair):
    """The repair: a block's MLP aux loss comes back from ``block_apply``
    (the MoE's, not 0), as the reference's does. The reduced configs are
    one block, so the reference's forward aux is that block's."""
    assert pair.tc.num_layers == 1
    x = transformer.embed_tokens(pair.params, pair.tc,
                                 torch.as_tensor(pair.toks))
    bp = transformer._layer(pair.params["groups"][0], 0)[0]
    _, aux = blocks.block_apply(bp, pair.tc, "attn", x, {"causal": True})
    assert pair.ref["aux"] > 0.5          # the reduced MoE's, ~1.36
    assert abs(float(aux) - pair.ref["aux"]) <= TOL * pair.ref["aux"]


def test_forward_logits_and_aux(pair):
    logits, aux = transformer.forward(pair.params, pair.tc,
                                      torch.as_tensor(pair.toks))
    assert _scaled_err(logits, pair.ref["forward"]) <= TOL
    assert abs(float(aux) - pair.ref["aux"]) <= TOL * pair.ref["aux"]


def test_dense_forward_keeps_an_aux_of_zero():
    tc = tget("qwen2-0.5b").reduced()
    params = transformer.init(torch.Generator().manual_seed(0), tc)
    _, aux = transformer.forward(params, tc,
                                 torch.zeros(1, 8, dtype=torch.int32))
    assert float(aux) == 0.0


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits(pair, last_only):
    logits, _ = transformer.prefill(pair.params, pair.tc,
                                    torch.as_tensor(pair.toks),
                                    max_len=MAX_LEN, last_only=last_only)
    want = pair.ref["prefill_last" if last_only else "prefill"]
    assert logits.shape == want.shape
    assert _scaled_err(logits, want) <= TOL


def test_prefill_caches_and_serve_steps(pair):
    """Prefill at T = B S = 160 (sorted branch), then ``STEPS`` decode
    steps at T = B (dense-local branch), caches written in place."""
    logits, caches = transformer.prefill(pair.params, pair.tc,
                                         torch.as_tensor(pair.toks),
                                         max_len=MAX_LEN)
    _assert_trees_close(caches, pair.ref["caches"])
    for i, (tok, want) in enumerate(pair.ref["steps"]):
        logits, caches = transformer.serve_step(
            pair.params, pair.tc, caches, torch.as_tensor(np.array(tok)),
            S + i)
        assert _scaled_err(logits, want) <= TOL, i
    _assert_trees_close(caches, pair.ref["step_caches"])


def test_short_prefill_takes_the_dense_local_branch(pair):
    """A prefill of T = 2 x 40 = 80 <= 64 top_k = 128: logits (all
    positions and last) and caches."""
    toks = pair.toks[:, :40]
    assert toks.size <= 64 * pair.tc.moe.top_k
    jl, jcache = _jprefill(pair.jp, pair.jc, jnp.asarray(toks), max_len=48)
    tl, tcache = transformer.prefill(pair.params, pair.tc,
                                     torch.as_tensor(toks), max_len=48)
    assert _scaled_err(tl, jl) <= TOL
    _assert_trees_close(tcache, _np_tree(jcache))
    last, _ = transformer.prefill(pair.params, pair.tc, torch.as_tensor(toks),
                                  max_len=48, last_only=True)
    assert _scaled_err(last, np.asarray(jl)[:, -1]) <= TOL


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_matches_reference(name):
    """Greedy tokens equal the reference's on the rows where every step's
    choice is decided by more than the logits' tolerance."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    seed, batch, prompt_len, gen = 3, 2, 70, 6
    want = np.asarray(jserve.lm_decode(jc, batch=batch, prompt_len=prompt_len,
                                       gen=gen, seed=seed)["generated"])
    params = params_from_numpy(
        _np_tree(_jinit(jax.random.PRNGKey(seed), jc)), "cpu")
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
# LM chapter training of the reduced deepseek-moe-16b
# ---------------------------------------------------------------------------

def test_fit_trains_the_moe_config_as_the_reference(monkeypatch):
    """``api.fit`` of the reduced deepseek-moe-16b, one chapter of two
    steps (the block task, whose loss carries the router's aux at 0.01,
    and the head task) from the reference's initial params and draws:
    params by the fit rule, eval CE at 1e-4, the same records and block
    losses at 1e-4."""
    name, seq = "deepseek-moe-16b", 16
    jc, tc = jget(name).reduced(), tget(name).reduced()
    npp = _np_tree(_jinit(jax.random.PRNGKey(0), jc))
    monkeypatch.setattr(pff_lm, "init_params",
                        lambda cfg, seed, device=None: params_from_numpy(
                            npp, "cpu"))
    kw = dict(chapters=1, steps_per_chapter=2, batch=4, seq=seq, lr=1e-3)
    want = japi.fit(jc, jdata.text_source(vocab=jc.vocab, seq_len=seq,
                                          seed=0), **kw)
    got = tapi.fit(tc, tdata.text_source(vocab=tc.vocab, seq_len=seq,
                                         seed=0), key=JaxKey(0),
                   device="cpu", **kw)
    assert [(r.kind, r.layer, r.chapter) for r in got.records] == \
        [(r.kind, r.layer, r.chapter) for r in want.records]
    np.testing.assert_allclose([l for _, l in got.history],
                               [l for _, l in want.history], rtol=1e-4)
    _assert_params_close(got.params, want.params)
    assert abs(got.eval_ce - want.eval_ce) <= 1e-4
    # the router trained: its gradient reached it through the gates and
    # the aux loss
    assert not np.array_equal(
        params_to_numpy(got.params)["groups"][0][0]["mlp"]["router"],
        npp["groups"][0][0]["mlp"]["router"])
    init_ce = float(ttrain.eval_ce(params_from_numpy(npp, "cpu"), tc,
                                   torch.as_tensor(tdata.text_source(
                                       vocab=tc.vocab, seq_len=seq,
                                       seed=0).blocks("val", 16, seed=321))))
    assert got.eval_ce < init_ce
