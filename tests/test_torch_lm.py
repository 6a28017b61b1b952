"""The port's LM serving slice on the CPU against the reference, at the
reduced configs (f32, d 256, 2 layers): the reference's own parameters
cross through numpy and ``convert.params_from_numpy``, the same tokens go
through both packages, and ``transformer.forward``, ``prefill`` (logits
and every cache leaf), ``serve_step`` and ``launch.serve.lm_decode`` are
held to the reference's at 1e-4 scaled error (max |port - reference| /
max |reference|), generated tokens equal where the next token is decided.
Also the configs, the Markov prompts (bit-identical), the bf16 parameter
crossing (bit-exact) and the two block kinds ported last, which once
raised."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro_torch import data as tdata
from repro_torch.configs import get_config as tget, reference_names
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks, transformer

NAMES = ["qwen2-0.5b", "mamba2-780m"]
# every config the port registers (the others' parity is in
# tests/test_torch_lm_families.py and tests/test_torch_moe.py)
REGISTERED = NAMES + ["tinyllama-1.1b", "qwen3-8b", "h2o-danube-3-4b",
                      "recurrentgemma-2b", "deepseek-moe-16b",
                      "qwen3-moe-235b-a22b", "seamless-m4t-large-v2",
                      "llama-3.2-vision-90b"]
TOL = 1e-4            # scaled error, f32
BF16_TOL = 2e-2       # scaled error of bf16 logits, ~2.5 bf16 ulps of the max
B, S, MAX_LEN, STEPS = 2, 40, 48, 4


def _scaled_err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """Both packages' reduced config, the reference's parameters (as
    numpy and in the port), and the reference's outputs on one batch."""
    name = request.param
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    npp = _np_tree(jp)
    toks = _tokens(jc.vocab)
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
    return types.SimpleNamespace(name=name, jc=jc, tc=tc, npp=npp, toks=toks,
                                 params=params_from_numpy(npp, "cpu"), ref=out)


def _assert_trees_close(port_tree, ref_tree):
    """Every leaf, matched by key, within TOL (int leaves exactly)."""
    def cmp(r, p):
        assert r.shape == p.shape and r.dtype == p.dtype, (r.shape, p.shape)
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(p, r)
        else:
            assert _scaled_err(p, r) <= TOL
    jax.tree_util.tree_map(cmp, ref_tree, params_to_numpy(port_tree))


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
    assert set(reference_names()) == set(REGISTERED)


def test_unknown_config_names_the_registered_ones():
    with pytest.raises(KeyError, match="qwen2-0.5b"):
        tget("no-such-config-7b")


@pytest.mark.parametrize("name", NAMES)
def test_init_tree_matches_reference_layout(name):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    want = jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0), jc))
    got = params_to_numpy(transformer.init(torch.Generator().manual_seed(0),
                                           tc))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(_np_tree(want)))
    jax.tree_util.tree_map(
        lambda w, g: (w.shape, w.dtype) == (g.shape, g.dtype) or pytest.fail(
            f"{w.shape} {w.dtype} != {g.shape} {g.dtype}"), want, got)
    assert transformer.param_count(params_from_numpy(got, "cpu")) == \
        jtr.param_count(want)


def test_forward_logits(pair):
    logits, aux = transformer.forward(pair.params, pair.tc,
                                      torch.as_tensor(pair.toks))
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    assert _scaled_err(logits, pair.ref["forward"]) <= TOL


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


def test_serve_step_logits_and_caches(pair):
    logits, caches = transformer.prefill(pair.params, pair.tc,
                                         torch.as_tensor(pair.toks),
                                         max_len=MAX_LEN)
    for i, (tok, want) in enumerate(pair.ref["steps"]):
        logits, caches = transformer.serve_step(
            pair.params, pair.tc, caches, torch.as_tensor(np.array(tok)), S + i)
        assert _scaled_err(logits, want) <= TOL, i
    _assert_trees_close(caches, pair.ref["step_caches"])


def test_init_caches_match_reference():
    for name in NAMES:
        jc, tc = jget(name).reduced(), tget(name).reduced()
        want = _np_tree(jtr.init_caches(jc, 3, 20))
        _assert_trees_close(transformer.init_caches(tc, 3, 20, device="cpu"),
                            want)


def test_ring_window_cache_prefill_and_decode():
    """A sliding window shorter than the cache: the ring-layout prefill
    branch and slot = pos % window in decode."""
    jc = dataclasses.replace(jget("qwen2-0.5b").reduced(), window=8)
    tc = dataclasses.replace(tget("qwen2-0.5b").reduced(), window=8)
    jp = jtr.init(jax.random.PRNGKey(1), jc)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    toks = _tokens(jc.vocab, seed=5)
    jl, jcache = jtr.prefill(jp, jc, jnp.asarray(toks), max_len=MAX_LEN)
    tl, tcache = transformer.prefill(tp, tc, torch.as_tensor(toks),
                                     max_len=MAX_LEN)
    assert _scaled_err(tl, jl) <= TOL
    _assert_trees_close(tcache, _np_tree(jcache))
    tok = jnp.argmax(jl[:, -1], axis=-1)
    for i in range(3):
        jl, jcache = jtr.serve_step(jp, jc, jcache, tok, S + i)
        tl, tcache = transformer.serve_step(tp, tc, tcache,
                                            torch.as_tensor(np.array(tok)),
                                            S + i)
        assert _scaled_err(tl, jl) <= TOL
        tok = jnp.argmax(jl, axis=-1)
    _assert_trees_close(tcache, _np_tree(jcache))


@pytest.mark.parametrize("name", NAMES)
def test_lm_decode_matches_reference(name):
    jc, tc = jget(name).reduced(), tget(name).reduced()
    seed, batch, prompt_len, gen = 3, 2, 12, 6
    want = np.asarray(jserve.lm_decode(jc, batch=batch, prompt_len=prompt_len,
                                       gen=gen, seed=seed)["generated"])
    params = params_from_numpy(
        _np_tree(jtr.init(jax.random.PRNGKey(seed), jc)), "cpu")
    res = tserve.lm_decode(tc, batch=batch, prompt_len=prompt_len, gen=gen,
                           seed=seed, params=params, device="cpu")
    got = res["generated"].numpy()
    assert got.shape == want.shape == (batch, gen)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0
    assert res["decode_tok_per_s"] == pytest.approx(
        batch * (gen - 1) / res["decode_s"])
    # The port's own trajectory (the same greedy steps) gives each step's
    # top-2 margin; a row is held to the reference's tokens while every
    # step's choice is decided by more than the logits' tolerance.
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


def test_lm_decode_samples_from_a_seeded_generator():
    tc = tget("mamba2-780m").reduced()
    params = transformer.init(torch.Generator().manual_seed(0), tc)
    runs = [tserve.lm_decode(tc, batch=2, prompt_len=8, gen=5, seed=s,
                             greedy=False, params=params, device="cpu")
            ["generated"] for s in (7, 7)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 5)
    assert bool(((runs[0] >= 0) & (runs[0] < tc.vocab)).all())


def test_lm_decode_draws_its_own_weights_from_the_seed():
    tc = tget("qwen2-0.5b").reduced()
    a, b = (tserve.lm_decode(tc, batch=1, prompt_len=6, gen=3, seed=0,
                             device="cpu")["generated"] for _ in range(2))
    assert torch.equal(a, b)


def test_lm_decode_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.lm_decode(tget("qwen2-0.5b").reduced(), batch=1, prompt_len=4,
                         gen=2)


@pytest.mark.parametrize("vocab,batch,seq_len,steps,seed", [
    (512, 2, 11, 1, 0), (151936, 4, 63, 1, 0), (50280, 3, 17, 2, 5)])
def test_lm_batches_are_bit_identical(vocab, batch, seq_len, steps, seed):
    want = list(jdata.lm_batches(vocab, batch, seq_len, steps, seed))
    got = list(tdata.lm_batches(vocab, batch, seq_len, steps, seed))
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_params_cross_bit_exactly(name):
    jc = dataclasses.replace(jget(name).reduced(), dtype="bfloat16")
    npp = _np_tree(jtr.init(jax.random.PRNGKey(2), jc))
    tp = params_from_numpy(npp, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    back = params_to_numpy(tp)

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    jax.tree_util.tree_map(same, npp, back)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_prefill_follows_the_reference_cast_points(name):
    jc = dataclasses.replace(jget(name).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(tget(name).reduced(), dtype="bfloat16")
    jp = jtr.init(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    toks = _tokens(jc.vocab, seed=6)
    want = np.asarray(jtr.prefill(jp, jc, jnp.asarray(toks),
                                  last_only=True)[0])
    got = transformer.prefill(tp, tc, torch.as_tensor(toks),
                              last_only=True)[0]
    assert _scaled_err(got, want) <= BF16_TOL


def test_pad_rows_are_masked():
    tc = tget("mamba2-780m").reduced()
    tc = dataclasses.replace(tc, vocab=500)          # padded to 512
    params = transformer.init(torch.Generator().manual_seed(0), tc)
    logits, _ = transformer.forward(params, tc, torch.zeros(1, 3, dtype=torch.int32))
    assert bool((logits[..., 500:] == -1e30).all())
    assert bool((logits[..., :500] > -1e29).all())


@pytest.mark.parametrize("kind", ["cross_attn", "xdec"])
def test_unported_block_kinds_raise(kind):
    """The two kinds that raised ``NotImplementedError`` until their
    slice now build and run their five functions on a reduced config
    (their parity is in ``tests/test_torch_vision_audio.py``); an unknown
    kind raises ``ValueError``."""
    tc = tget("llama-3.2-vision-90b" if kind == "cross_attn"
              else "seamless-m4t-large-v2").reduced()
    gen = torch.Generator().manual_seed(0)
    x, aux = torch.randn(1, 4, tc.d_model), torch.randn(1, 3, tc.d_model)
    ctx = {"aux": aux, "max_len": 6}
    p = blocks.block_init(gen, tc, kind)
    y, loss = blocks.block_apply(p, tc, kind, x, ctx)
    yp, cache = blocks.block_prefill(p, tc, kind, x, ctx)
    assert torch.equal(y, yp) and float(loss) == 0.0
    empty = blocks.block_cache_init(tc, kind, 1, 6, torch.float32, "cpu")
    cross = empty if kind == "cross_attn" else empty["cross"]
    assert cross["k"].shape == (1, tc.vision_tokens or tc.enc_seq, tc.n_kv,
                                tc.resolved_head_dim)
    assert bool((cross["kpos"] == -1).all())
    y1, _ = blocks.block_decode(p, tc, kind, cache, x[:, 0], 4, {})
    assert y1.shape == (1, tc.d_model) and bool(torch.isfinite(y1).all())
    for call in (lambda: blocks.block_init(gen, tc, "nope"),
                 lambda: blocks.block_apply(p, tc, "nope", x, ctx)):
        with pytest.raises(ValueError, match="nope"):
            call()


def test_moe_mlp_raises():
    """The MoE MLP is ported (``mlp_init`` builds the reference's tree),
    and so is expert parallelism: an enabled ``Dist`` (a mesh and a
    model axis) constructs and reads the model axis's size; one without
    a model axis stays disabled."""
    from repro_torch.models import mlp
    tc = tget("deepseek-moe-16b").reduced()
    p = blocks.mlp_init(torch.Generator().manual_seed(0), tc)
    assert set(p) == {"router", "wi", "wg", "wo", "shared"}
    assert not mlp.NO_DIST.enabled and mlp.NO_DIST.model_size() == 1
    assert not mlp.Dist(mesh=object()).enabled
    mesh = type("M", (), {"shape": {"data": 2, "model": 4}})()
    d = mlp.Dist(mesh=mesh, batch_axes=("data",), model_axis="model")
    assert d.enabled and d.model_size() == 4
    x = torch.ones(2, 3)
    assert d.constrain_batch(x) is x


def test_cli_lm_mode_on_the_cpu(capsys):
    assert tserve.main(["--mode", "lm", "--arch", "mamba2-780m", "--batch",
                        "2", "--prompt-len", "8", "--gen", "3", "--device",
                        "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill ") and "tok/s" in out[0]
    assert out[1].startswith("first generated rows:")


def test_cli_ff_mode_is_not_ported(monkeypatch):
    """``--mode ff`` (now the default) is ported: without ``--device
    cpu`` on a machine with no card it refuses to carry on on the CPU
    (``tests/test_torch_train_while_serve.py`` runs it with
    ``--device cpu``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--epochs", "2", "--splits", "2", "--width", "16",
                     "--n-train", "64", "--nodes", "1"])


def test_cli_lm_mode_needs_arch(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "lm", "--device", "cpu"])
    assert "--mode lm requires --arch" in capsys.readouterr().err
