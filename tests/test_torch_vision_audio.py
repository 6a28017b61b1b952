"""The port's encoder-decoder and vision configs on the CPU against the
reference: ``seamless-m4t-large-v2`` (a bidirectional ``attn`` encoder
over stub audio frames, then ``xdec`` decoder blocks: causal
self-attention, cross attention, MLP) and ``llama-3.2-vision-90b``
(``attn`` blocks and a ``cross_attn`` block over stub vision patches).

Every cross attention scales its output by ``tanh(gate)``, and ``init``
sets each gate to 0, as the reference's does: a fresh model's logits do
not depend on ``aux`` at all, so a comparison at init would pass with
any cross attention. Every comparison here sets the gates to 1.0 in the
reference's parameters first, and ``test_halved_aux_moves_the_logits``
shows that the comparisons then see the cross path.

The configs match the reference's field for field, full and reduced.
The same numpy inputs and the reference's own parameters (through
``convert.params_from_numpy``) go through both packages at ``TOL`` =
1e-4 scaled error (max |port - reference| / max |reference|): the
``cross_attn`` and ``xdec`` blocks (apply, prefill and its cache, one
decode step) with Sq != Sk, at MHA and at GQA; ``encode``; and the
whole reduced model (``forward``, ``prefill`` logits and caches, serve
steps, ``lm_decode`` tokens on decided rows). The attention kernel at
these shapes is held against its plain version on the card by
``chip_smoke.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import blocks as jblocks, transformer as jtr
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks, transformer

from test_torch_lm import _assert_trees_close, _np_tree, _scaled_err

NAMES = ["seamless-m4t-large-v2", "llama-3.2-vision-90b"]
TOL = 1e-4            # scaled error, f32
GATE = 1.0            # tanh(1) = 0.76: the cross path weighs in
# decoder tokens against the reduced configs' 16 encoder frames and 8
# vision patches: Sq != Sk in every cross attention
B, S, STEPS = 2, 24, 3
MAX_LEN = S + STEPS

# the reference's functions under jit (one compile each, where eager
# dispatch compiles op by op): the same numerics, a fraction of the time
_jinit = jax.jit(jtr.init, static_argnums=1)
_jforward = jax.jit(jtr.forward, static_argnums=1)
_jencode = jax.jit(jtr.encode, static_argnums=1)
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


def _gated(tree, value=GATE):
    """The reference's parameter tree with every cross-attention gate
    set to ``value``."""
    if isinstance(tree, dict):
        return {k: jnp.full_like(v, value) if k == "gate" else _gated(v, value)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gated(v, value) for v in tree)
    return tree


def _gate_leaves(tree):
    if isinstance(tree, dict):
        return [v for k, v in tree.items() if k == "gate"] + [
            g for k, v in tree.items() if k != "gate"
            for g in _gate_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [g for v in tree for g in _gate_leaves(v)]
    return []


def _aux_tokens(cfg):
    return cfg.enc_seq if cfg.enc_dec else cfg.vision_tokens


def _inputs(cfg, seed=0, batch=B, seq=S):
    """Tokens (batch, seq) and stub embeddings (batch, T, d), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    aux = rng.standard_normal((batch, _aux_tokens(cfg), cfg.d_model))
    return toks, aux.astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and parameter trees
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
    assert ([i[3] for i in transformer.group_infos(tc)]
            == [i[3] for i in jtr.group_infos(jc)])


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_reference_and_keeps_gates_at_zero(name):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    want = jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0), jc))
    tp = transformer.init(torch.Generator().manual_seed(0), tc)
    got = params_to_numpy(tp)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(_np_tree(want)))
    for w, g in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert (w.shape, w.dtype) == (g.shape, g.dtype)
    gates = _gate_leaves(tp)
    # one per cross attention: a cross_attn block's, an xdec block's xattn
    assert len(gates) == 1
    assert gates[0].dtype == torch.float32 and gates[0].shape == (1,)
    assert not bool(gates[0].any())
    assert ("enc_norm" in got) == jc.enc_dec


@pytest.mark.parametrize("name", NAMES)
def test_init_caches_match_reference(name):
    """Stacked empty caches; ``None`` for the encoder's group."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    want = _np_tree(jtr.init_caches(jc, 3, 20))
    got = transformer.init_caches(tc, 3, 20, device="cpu")
    assert (got[0] is None) == jc.enc_dec
    _assert_trees_close(got, want)


# ---------------------------------------------------------------------------
# The cross_attn and xdec blocks
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    # (config, kind, n_kv): MHA as reduced, and GQA (n_kv 2 of 4 heads)
    "cross_attn-mha": ("llama-3.2-vision-90b", "cross_attn", None),
    "cross_attn-gqa": ("llama-3.2-vision-90b", "cross_attn", 2),
    "xdec-mha": ("seamless-m4t-large-v2", "xdec", None),
    "xdec-gqa": ("seamless-m4t-large-v2", "xdec", 2),
}
BLOCK_S, BLOCK_T = 12, 7            # decoder rows and aux rows


@pytest.fixture(scope="module", params=list(BLOCK_CASES))
def block(request):
    """Both packages' config, the reference's block parameters (gates
    set), the inputs, and the reference's apply, prefill (output and
    cache) and one decode step after the prefill."""
    name, kind, n_kv = BLOCK_CASES[request.param]
    jc, tc = jget(name).reduced(), tget(name).reduced()
    if n_kv:
        jc = dataclasses.replace(jc, n_kv=n_kv)
        tc = dataclasses.replace(tc, n_kv=n_kv)
    jp = _gated(jblocks.block_init(jax.random.PRNGKey(3), jc, kind))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, BLOCK_S, jc.d_model)).astype(np.float32)
    aux = rng.standard_normal((B, BLOCK_T, jc.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, jc.d_model)).astype(np.float32)
    max_len = BLOCK_S + 2

    def run(p, x, aux, x1):
        ctx = {"causal": True, "aux": aux, "max_len": max_len}
        y, _ = jblocks.block_apply(p, jc, kind, x, ctx)
        yp, cache = jblocks.block_prefill(p, jc, kind, x, ctx)
        yd, cache_d = jblocks.block_decode(p, jc, kind, cache, x1, BLOCK_S,
                                           ctx)
        return y, yp, cache, yd, cache_d

    ref = _np_tree(jax.jit(run)(jp, x, aux, x1))
    return dataclasses.make_dataclass(
        "Block", ["kind", "tc", "params", "x", "aux", "x1", "max_len",
                  "ref"])(kind, tc, params_from_numpy(_np_tree(jp), "cpu"),
                          torch.as_tensor(x), torch.as_tensor(aux),
                          torch.as_tensor(x1), max_len, ref)


def _ctx(b):
    return {"causal": True, "aux": b.aux, "max_len": b.max_len}


def test_block_apply(block):
    y, aux_loss = blocks.block_apply(block.params, block.tc, block.kind,
                                     block.x, _ctx(block))
    assert y.shape == block.x.shape and float(aux_loss) == 0.0
    assert _scaled_err(y, block.ref[0]) <= TOL


def test_block_prefill_and_its_cache(block):
    y, cache = blocks.block_prefill(block.params, block.tc, block.kind,
                                    block.x, _ctx(block))
    assert _scaled_err(y, block.ref[1]) <= TOL
    _assert_trees_close(cache, block.ref[2])
    cross = cache if block.kind == "cross_attn" else cache["cross"]
    assert cross["k"].shape[1] == BLOCK_T          # Sk != Sq


def test_block_decode_after_prefill(block):
    _, cache = blocks.block_prefill(block.params, block.tc, block.kind,
                                    block.x, _ctx(block))
    y, _ = blocks.block_decode(block.params, block.tc, block.kind, cache,
                               block.x1, BLOCK_S, {})
    assert _scaled_err(y, block.ref[3]) <= TOL
    # the self cache is written in place; the cross cache is read only
    _assert_trees_close(cache, block.ref[4])


# ---------------------------------------------------------------------------
# The whole reduced model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """Both packages' reduced config, the reference's parameters with the
    gates set (as numpy and in the port), the inputs, and the reference's
    outputs: forward, prefill (all positions and last), caches, ``STEPS``
    greedy serve steps with their caches, and the encoder's output."""
    name = request.param
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = _gated(_jinit(jax.random.PRNGKey(0), jc))
    toks, aux = _inputs(jc)
    jt, ja = jnp.asarray(toks), jnp.asarray(aux)
    ref = {"forward": np.asarray(_jforward(jp, jc, jt, aux=ja)[0])}
    ref["prefill_last"] = np.asarray(_jprefill(
        jp, jc, jt, aux=ja, max_len=MAX_LEN, last_only=True)[0])
    logits, caches = _jprefill(jp, jc, jt, aux=ja, max_len=MAX_LEN)
    ref["prefill"], ref["caches"] = np.asarray(logits), _np_tree(caches)
    tok, steps = jnp.argmax(logits[:, -1], axis=-1), []
    for i in range(STEPS):
        logits, caches = _jstep(jp, jc, caches, tok, jnp.int32(S + i))
        steps.append((np.asarray(tok), np.asarray(logits)))
        tok = jnp.argmax(logits, axis=-1)
    ref["steps"], ref["step_caches"] = steps, _np_tree(caches)
    if jc.enc_dec:
        ref["encode"] = np.asarray(_jencode(jp, jc, ja)[0])
    return dataclasses.make_dataclass(
        "Pair", ["name", "jc", "tc", "jp", "params", "toks", "aux", "ref"])(
        name, jc, tc, jp, params_from_numpy(_np_tree(jp), "cpu"),
        torch.as_tensor(toks), torch.as_tensor(aux), ref)


def test_encode(pair):
    if not pair.tc.enc_dec:
        # a vision config has no encoder: cross attention reads aux
        assert not transformer.groups_of(pair.tc, encoder=True)
        return
    out, aux_loss = transformer.encode(pair.params, pair.tc, pair.aux)
    assert out.shape == pair.aux.shape and float(aux_loss) == 0.0
    assert _scaled_err(out, pair.ref["encode"]) <= TOL


def test_forward_logits(pair):
    logits, aux_loss = transformer.forward(pair.params, pair.tc, pair.toks,
                                           aux=pair.aux)
    assert logits.dtype == torch.float32 and float(aux_loss) == 0.0
    assert _scaled_err(logits, pair.ref["forward"]) <= TOL


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_logits(pair, last_only):
    logits, _ = transformer.prefill(pair.params, pair.tc, pair.toks,
                                    aux=pair.aux, max_len=MAX_LEN,
                                    last_only=last_only)
    want = pair.ref["prefill_last" if last_only else "prefill"]
    assert logits.shape == want.shape
    assert _scaled_err(logits, want) <= TOL


def test_prefill_caches_and_serve_steps(pair):
    """Prefill fills the self and cross caches (``None`` for the
    encoder's group); each decode step writes its self caches in place."""
    logits, caches = transformer.prefill(pair.params, pair.tc, pair.toks,
                                         aux=pair.aux, max_len=MAX_LEN)
    _assert_trees_close(caches, pair.ref["caches"])
    for i, (tok, want) in enumerate(pair.ref["steps"]):
        logits, caches = transformer.serve_step(
            pair.params, pair.tc, caches, torch.as_tensor(np.array(tok)),
            S + i)
        assert _scaled_err(logits, want) <= TOL, i
    _assert_trees_close(caches, pair.ref["step_caches"])


def test_halved_aux_moves_the_logits(pair):
    """The comparisons are not vacuous: with the gates set, halving aux
    moves the reference's logits by far more than ``TOL``; with the gates
    at init (0) it moves them not at all, in either package."""
    moved = _scaled_err(
        _jforward(pair.jp, pair.jc, jnp.asarray(pair.toks),
                  aux=jnp.asarray(pair.aux) * 0.5)[0], pair.ref["forward"])
    assert moved > 100 * TOL, moved
    zero = params_from_numpy(_np_tree(_gated(pair.jp, 0.0)), "cpu")
    a, b = (transformer.forward(zero, pair.tc, pair.toks, aux=pair.aux * f)[0]
            for f in (1.0, 0.5))
    assert torch.equal(a, b)


def test_forward_needs_aux(pair):
    with pytest.raises(ValueError, match="pass aux"):
        transformer.forward(pair.params, pair.tc, pair.toks)


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_matches_reference(name, monkeypatch):
    """The reference's own ``lm_decode`` (its init made to set the gates)
    against the port's, given the reference's parameters and its stub
    embeddings (``jax.random.normal`` of the seed's key): greedy tokens
    equal on the rows where every step's choice is decided by more than
    the logits' tolerance."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    seed, batch, prompt_len, gen = 3, 2, 20, 5
    monkeypatch.setattr(jtr, "init",
                        lambda key, cfg: _gated(_jinit(key, cfg)))
    want = np.asarray(jserve.lm_decode(jc, batch=batch, prompt_len=prompt_len,
                                       gen=gen, seed=seed)["generated"])
    key = jax.random.PRNGKey(seed)
    params = params_from_numpy(_np_tree(_gated(_jinit(key, jc))), "cpu")
    aux = torch.as_tensor(np.array(jax.random.normal(
        key, (batch, _aux_tokens(jc), jc.d_model), jc.dtype)))
    res = tserve.lm_decode(tc, batch=batch, prompt_len=prompt_len, gen=gen,
                           seed=seed, params=params, aux=aux, device="cpu")
    got = res["generated"].numpy()
    assert got.shape == want.shape == (batch, gen)
    prompts = next(iter(tdata.lm_batches(tc.vocab, batch, prompt_len - 1, 1,
                                         seed)))
    logits, caches = transformer.prefill(params, tc, torch.as_tensor(prompts),
                                         aux=aux, max_len=prompt_len + gen,
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


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_draws_the_stub_embeddings_from_the_seed(name):
    """Without ``aux``, ``lm_decode`` serves ``frontend_embeddings``:
    (batch, T, d) in the config's dtype, the same for the same seed."""
    tc = tget(name).reduced()
    params = transformer.init(torch.Generator().manual_seed(0), tc)
    aux = tserve.frontend_embeddings(tc, 2, 7, "cpu")
    assert aux.shape == (2, _aux_tokens(tc), tc.d_model)
    assert aux.dtype == torch.float32
    assert torch.equal(aux, tserve.frontend_embeddings(tc, 2, 7, "cpu"))
    assert not torch.equal(aux, tserve.frontend_embeddings(tc, 2, 8, "cpu"))
    assert tserve.frontend_embeddings(tget("qwen2-0.5b").reduced(), 2, 7,
                                      "cpu") is None
    kw = dict(batch=2, prompt_len=10, gen=3, seed=7, params=params,
              device="cpu")
    assert torch.equal(tserve.lm_decode(tc, **kw)["generated"],
                       tserve.lm_decode(tc, aux=aux, **kw)["generated"])


@pytest.mark.parametrize("name", NAMES)
def test_cli_lm_mode_serves_the_config(name, capsys):
    assert tserve.main(["--mode", "lm", "--arch", name, "--batch", "2",
                        "--prompt-len", "8", "--gen", "3", "--device",
                        "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill ") and "tok/s" in out[0]
