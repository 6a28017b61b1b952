"""The port's LM chapter training on the CPU against the reference: the
BPE encoder and the real-text token blocks (bit-identical), the token
corruptions (bit-identical under the reference's own draws, ``JaxKey``),
``eval_ce``, one block step per block index, the head step and
``train_chapters``, all from the reference's own initial parameters
(``convert.params_from_numpy``) at a small qwen2-0.5b (``.reduced()``, 3
attention blocks, seq 16). ``tests/test_torch_lm_exec.py`` holds the
joint FF and backprop steps, the executor and the kernel repair.

Tolerances: losses and ``eval_ce`` at 1e-5 (relative). Params after
Adam steps by ``tests/test_torch_fit.py``'s rule (at most 1 in 10^4
elements of each leaf beyond 1e-4, every element within 1e-3), where a
leaf smaller than 10^4 elements may hold one such element: Adam's first
step moves each weight by lr * g / (|g| + 1e-8), so a weight whose
gradient is within rounding of zero moves by up to lr = 1e-3 on a
rounding-level difference of its gradient. From the same start, the
bulk of a leaf agrees to ~1e-6 and a few such weights by up to 3e-4
(the 384 attention biases hold one at 2.1e-4 after one backprop
step)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata, optim as joptim
from repro.configs import get_config as jget
from repro.core import ff as jff, pff_lm as jlm, train as jtrain
from repro.data import encoder as jenc
from repro.models import transformer as jtr
from repro_torch import data as tdata, optim as toptim
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ff as tff, pff_lm, train as ttrain
from repro_torch.core.rng import TorchKey
from repro_torch.data import encoder as tenc

from test_torch_fit import OUTLIER_SHARE, OUTLIER_TOL, WEIGHT_TOL
from test_torch_train import JaxKey

LOSS_TOL = 1e-5
N_BLOCKS, SEQ, BATCH = 3, 16, 4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's side: these are many small ops,
    which more threads only slow down under the test workers (and the
    results then do not depend on the machine's thread count)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(name="qwen2-0.5b", n_blocks=N_BLOCKS, **kw):
    kind = "attn" if name == "qwen2-0.5b" else "mamba2"
    out = []
    for get in (jget, tget):
        c = get(name).reduced()
        c = dataclasses.replace(c, num_layers=n_blocks,
                                groups=(((kind,), n_blocks),))
        if kw:
            c = dataclasses.replace(c, ff=dataclasses.replace(c.ff, **kw))
        out.append(c)
    return out


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    npp = jax.tree_util.tree_map(np.asarray, jp)
    src = tdata.text_source(vocab=tc.vocab, seq_len=SEQ, seed=0)
    tok = src.blocks("train", BATCH, seed=5)
    return dataclasses.make_dataclass("S", ["jc", "tc", "jp", "npp", "tok"])(
        jc, tc, jp, npp, tok)


def _port(npp):
    return params_from_numpy(npp, "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_close(port_tree, ref_tree):
    got = params_to_numpy(port_tree)
    want = _np(ref_tree)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        d = np.abs(a.astype(np.float64) - b.astype(np.float64))
        assert float(d.max()) <= OUTLIER_TOL, float(d.max())
        assert (d > WEIGHT_TOL).sum() <= max(OUTLIER_SHARE * d.size, 1), \
            np.sort(d.ravel())[-5:]


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# Data: the BPE encoder and the token blocks, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [300, 512])
def test_encoder_merges_and_ids_are_the_references(vocab):
    text = tenc.corpus_text()
    assert text == jenc.corpus_text()
    te, je = tenc.train_bpe(text, vocab), jenc.train_bpe(text, vocab)
    assert te.merges == je.merges and te.n_vocab == je.n_vocab
    ids = te.encode(text)
    assert ids == je.encode(text)
    assert te.decode(ids) == text
    assert len(ids) < len(text)
    assert tenc.default_encoder(512).merges == jenc.default_encoder(512).merges
    with pytest.raises(ValueError, match="vocab_size >= 256"):
        tenc.train_bpe(text, 100)


@pytest.mark.parametrize("seq_len", [16, 256])
def test_text_source_blocks_are_the_references(seq_len):
    t = tdata.text_source(vocab=512, seq_len=seq_len, seed=0)
    j = jdata.text_source(vocab=512, seq_len=seq_len, seed=0)
    np.testing.assert_array_equal(t.ids, j.ids)
    for split, n, seed in [("train", 8, 3), ("val", 16, 321),
                           ("train", 12, 2 * 1009 + 1)]:
        a, b = t.blocks(split, n, seed=seed), j.blocks(split, n, seed=seed)
        assert a.dtype == np.int32 and a.shape == (n, seq_len + 1)
        np.testing.assert_array_equal(a, b)
    for x, y in zip(t.sample("train", 4, seed=1), j.sample("train", 4,
                                                           seed=1)):
        np.testing.assert_array_equal(x, y)
    assert t.vocab == j.vocab == 512
    # the source stays a pure function of its arguments
    np.testing.assert_array_equal(t.blocks("train", 8, seed=3),
                                  t.blocks("train", 8, seed=3))
    assert not np.array_equal(t.blocks("train", 8, seed=3),
                              t.blocks("val", 8, seed=3))


# ---------------------------------------------------------------------------
# Negatives: the reference's draws give the reference's tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((4, 16), 0), ((3, 40), 1),
                                        ((2, 7), 2)])
def test_corrupt_tokens_are_the_references(shape, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 512, shape).astype(np.int32)
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    want = np.asarray(jff.corrupt_tokens(k, jnp.asarray(tok), 512))
    got = tff.corrupt_tokens(JaxKey(k), torch.as_tensor(tok), 512)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    logits = rng.standard_normal(shape + (512,)).astype(np.float32)
    want = np.asarray(jff.adaptive_corrupt_tokens(k, jnp.asarray(tok),
                                                  jnp.asarray(logits)))
    got = tff.adaptive_corrupt_tokens(JaxKey(k), torch.as_tensor(tok),
                                      torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_key_draws_for_the_lm():
    key = TorchKey(3)
    b = key.bernoulli((64, 64), 0.3)
    assert b.dtype == torch.bool and abs(float(b.float().mean()) - 0.3) < 0.03
    assert torch.equal(b, TorchKey(3).bernoulli((64, 64), 0.3))
    logits = torch.full((2, 5, 7), float("-inf"))
    logits[..., 4] = 0.0
    assert torch.equal(key.categorical(logits), torch.full((2, 5), 4))
    tok = torch.randint(0, 50, (4, 33), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    neg = tff.corrupt_tokens(key, tok, 50)
    assert neg.shape == tok.shape and neg.dtype == tok.dtype
    assert bool((neg != tok).any())
    assert torch.equal(neg, tff.corrupt_tokens(TorchKey(3), tok, 50))


# ---------------------------------------------------------------------------
# The trainers' pieces against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-780m"])
def test_eval_ce_matches_reference(name):
    jc, tc = _cfgs(name, n_blocks=1)
    jp = jtr.init(jax.random.PRNGKey(1), jc)
    ev = tdata.text_source(vocab=tc.vocab, seq_len=SEQ,
                           seed=0).blocks("val", 16, seed=321)
    want = float(jtrain.eval_ce(jp, jc, jnp.asarray(ev)))
    got = ttrain.eval_ce(_port(_np(jp)), tc, torch.as_tensor(ev))
    assert _rel(got, want) <= LOSS_TOL


@pytest.mark.parametrize("k", range(N_BLOCKS))
def test_block_step_matches_reference_and_touches_only_its_block(setup, k):
    batch = {"tokens": setup.tok}
    want_p, _, want_l = jlm.make_block_step(setup.jc, lr=1e-3)(
        setup.jp, joptim.adam_init(setup.jp),
        {"tokens": jnp.asarray(setup.tok)}, k, 1)
    p0 = _port(setup.npp)
    step = pff_lm.make_block_step(setup.tc, lr=1e-3, key_fn=JaxKey)
    got_p, _, got_l = step(_port(setup.npp), toptim.adam_init(p0),
                           {"tokens": torch.as_tensor(batch["tokens"])}, k,
                           1)
    assert _rel(got_l, want_l) <= LOSS_TOL
    _assert_params_close(got_p, want_p)
    # block k moved, every other block and the head left bit for bit
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(p0)),
                    jax.tree_util.tree_leaves(params_to_numpy(got_p))):
        if a.ndim and a.shape[0] == N_BLOCKS and a.ndim > 1:
            for j in range(N_BLOCKS):
                if j != k:
                    np.testing.assert_array_equal(a[j], b[j])
    moved = [not np.array_equal(a[k], b[k]) for a, b in zip(
        jax.tree_util.tree_leaves(params_to_numpy(p0["groups"])),
        jax.tree_util.tree_leaves(params_to_numpy(got_p["groups"])))]
    assert all(moved)
    for name in ("embed", "final_norm"):
        assert torch.equal(p0[name], got_p[name])


def test_head_step_matches_reference_and_moves_the_head(setup):
    want_p, _, want_l = jlm.make_head_step(setup.jc, head_lr=1e-3)(
        setup.jp, joptim.adam_init(setup.jp),
        {"tokens": jnp.asarray(setup.tok)}, 1)
    p0 = _port(setup.npp)
    got_p, _, got_l = pff_lm.make_head_step(setup.tc, head_lr=1e-3)(
        _port(setup.npp), toptim.adam_init(p0),
        {"tokens": torch.as_tensor(setup.tok)}, 1)
    assert _rel(got_l, want_l) <= LOSS_TOL
    _assert_params_close(got_p, want_p)
    for name in pff_lm.head_param_names(setup.tc):
        assert not torch.equal(p0[name], got_p[name]), name
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(p0["groups"])),
                    jax.tree_util.tree_leaves(
                        params_to_numpy(got_p["groups"]))):
        np.testing.assert_array_equal(a, b)


def test_train_chapters_matches_reference(setup):
    """2 chapters x 2 steps on the real-text blocks, the reference's
    initial params and draws: params by the fit rule, eval CE at 1e-4,
    the same records and per-task FF losses."""
    jsrc = jdata.text_source(vocab=setup.jc.vocab, seq_len=SEQ, seed=0)
    tsrc = tdata.text_source(vocab=setup.tc.vocab, seq_len=SEQ, seed=0)
    # lr 1e-3, the facade's default: the rule's 1e-3 bound is one step
    kw = dict(chapters=2, steps_per_chapter=2, lr=1e-3)
    want_p, want_r, want_l = jlm.train_chapters(
        setup.jc, jlm.chapter_batches(jsrc, batch=BATCH, steps=2), **kw)
    got_p, got_r, got_l = pff_lm.train_chapters(
        setup.tc, pff_lm.chapter_batches(tsrc, batch=BATCH, steps=2,
                                         device="cpu"),
        params=_port(setup.npp), key_fn=JaxKey, **kw)
    assert [(r.kind, r.layer, r.chapter) for r in got_r] == \
        [(r.kind, r.layer, r.chapter) for r in want_r]
    assert len(got_l) == 2 * N_BLOCKS
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    _assert_params_close(got_p, want_p)
    ev = tsrc.blocks("val", 16, seed=321)
    want_ce = float(jtrain.eval_ce(want_p, setup.jc, jnp.asarray(ev)))
    got_ce = float(ttrain.eval_ce(got_p, setup.tc, torch.as_tensor(ev)))
    assert abs(got_ce - want_ce) <= 1e-4
    init_ce = float(ttrain.eval_ce(_port(setup.npp), setup.tc,
                                   torch.as_tensor(ev)))
    assert got_ce < init_ce
