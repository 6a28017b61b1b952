"""The port's LM trainers on the encoder-decoder and vision configs
against the reference, on the CPU: the joint FF step, the backprop step
and ``eval_ce`` of the reduced ``seamless-m4t-large-v2`` (a bidirectional
encoder over stub audio frames, then ``xdec`` blocks) and
``llama-3.2-vision-90b`` (``attn`` blocks and a ``cross_attn`` block
over stub vision patches), each fed the same stub embeddings ``aux``
(numpy, from a seed) through ``batch["aux"]``.

The reference's initial parameters go to both packages (through
``convert.params_from_numpy``) with every cross-attention gate set to
1.0: init leaves them 0, and ``tanh(0)`` keeps the cross path out of the
loss and out of every gradient but the gate's (``test_zero_gates_...``
shows that). The port draws the reference's own numbers (``JaxKey``).
Tolerances are ``tests/test_torch_lm_train.py``'s: losses within
``LOSS_TOL`` relative, params through ``_assert_params_close``. The
joint FF step FF-trains the encoder's units before the decoder's; a
step that skipped them would leave every encoder leaf where it was,
which ``_assert_params_close`` and the moved-leaf count both catch."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_config as jget
from repro.core import train as jtrain
from repro.models import transformer as jtr
from repro_torch import optim as toptim
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import train as ttrain
from repro_torch.models import transformer

from test_torch_lm_train import (LOSS_TOL, _assert_params_close, _rel,
                                 one_thread)  # noqa: F401
from test_torch_train import JaxKey
from test_torch_vision_audio import _gated

NAMES = ["seamless-m4t-large-v2", "llama-3.2-vision-90b"]
# S equals the reduced seamless encoder's 16 frames: perf_opt scores the
# encoder's outputs against the token labels, which needs that (the
# reference's chunk reshape, and the port's check, refuse other lengths)
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _case(name):
    """The reduced config in both packages, the reference's initial
    params with the gates at 1.0 (numpy), tokens (B, S+1) and stub
    embeddings (B, T, d) from a numpy seed."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    npp = jax.tree_util.tree_map(
        np.asarray, _gated(jtr.init(jax.random.PRNGKey(0), jc)))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    T = transformer.aux_tokens(tc)
    aux = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    return dataclasses.make_dataclass(
        "Case", ["name", "jc", "tc", "npp", "tok", "aux"])(
        name, jc, tc, npp, tok, aux)


@pytest.fixture(params=NAMES)
def case(request):
    return _case(request.param)


@functools.lru_cache(maxsize=None)
def _ref_bp_step(name):
    """The reference's backprop step for ``_case(name)``, compiled once
    for both tests that run it."""
    return jax.jit(jtrain.make_bp_train_step(_case(name).jc, lr=1e-3))


def _batches(case, aux_scale=1.0):
    a = case.aux * aux_scale
    return ({"tokens": jnp.asarray(case.tok), "aux": jnp.asarray(a)},
            {"tokens": torch.as_tensor(case.tok), "aux": torch.as_tensor(a)})


def _with_ff(cfg, goodness, neg_mode):
    return dataclasses.replace(cfg, ff=dataclasses.replace(
        cfg.ff, goodness=goodness, neg_mode=neg_mode))


def _encoder_leaves(cfg, tree):
    """The leaves of the encoder's groups (numpy trees)."""
    return [leaf for gi, _, _, is_enc in jtr.group_infos(cfg) if is_enc
            for leaf in jax.tree_util.tree_leaves(tree["groups"][gi])]


def _moved(before, after):
    return [not np.array_equal(a, b) for a, b in zip(before, after)]


@pytest.mark.parametrize("name,goodness,neg_mode", [
    (name, "sumsq", "random") for name in NAMES] + [
    (name, "perf_opt", "random") for name in NAMES] + [
    ("seamless-m4t-large-v2", "sumsq", "adaptive")])
def test_joint_ff_step_matches_reference(name, goodness, neg_mode):
    case = _case(name)
    jc = _with_ff(case.jc, goodness, neg_mode)
    tc = _with_ff(case.tc, goodness, neg_mode)
    jb, tb = _batches(case)
    jp = jax.tree_util.tree_map(jnp.asarray, case.npp)
    want_p, _, want_m = jax.jit(jtrain.make_ff_train_step(jc, lr=1e-3))(
        jp, joptim.adam_init(jp), jb, 1)
    p0 = params_from_numpy(case.npp, "cpu")
    got_p, _, got_m = ttrain.make_ff_train_step(tc, lr=1e-3, key_fn=JaxKey)(
        p0, toptim.adam_init(p0), tb, 1)
    assert set(got_m) == set(want_m)
    for name in want_m:
        assert abs(float(got_m[name]) - float(want_m[name])) <= \
            LOSS_TOL * max(abs(float(want_m[name])), 1.0), name
    _assert_params_close(got_p, want_p)
    # every encoder leaf moves, in both packages; enc_norm (a head key
    # with a zero grad) stays
    got_np = params_to_numpy(got_p)
    want_np = jax.tree_util.tree_map(np.asarray, want_p)
    enc0 = _encoder_leaves(jc, case.npp)
    assert bool(enc0) == jc.enc_dec
    assert all(_moved(enc0, _encoder_leaves(jc, want_np)))
    assert all(_moved(enc0, _encoder_leaves(jc, got_np)))
    if jc.enc_dec:
        assert np.array_equal(got_np["enc_norm"], case.npp["enc_norm"])
        assert np.array_equal(want_np["enc_norm"], case.npp["enc_norm"])


def test_bp_step_matches_reference(case):
    jb, tb = _batches(case)
    jp = jax.tree_util.tree_map(jnp.asarray, case.npp)
    want_p, _, want_m = _ref_bp_step(case.name)(
        jp, joptim.adam_init(jp), jb, 1)
    p0 = params_from_numpy(case.npp, "cpu")
    got_p, _, got_m = ttrain.make_bp_train_step(case.tc, lr=1e-3)(
        p0, toptim.adam_init(p0), tb, 1)
    assert _rel(got_m["loss_ce"], want_m["loss_ce"]) <= LOSS_TOL
    _assert_params_close(got_p, want_p)


def test_eval_ce_matches_reference_and_sees_the_cross_path(case):
    p = params_from_numpy(case.npp, "cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, case.npp)
    ces = []
    for scale in (1.0, 0.5):
        jb, tb = _batches(case, scale)
        want = float(jtrain.eval_ce(jp, case.jc, jb["tokens"], jb["aux"]))
        got = float(ttrain.eval_ce(p, case.tc, tb["tokens"], tb["aux"],
                                   impl="ref"))
        assert _rel(got, want) <= LOSS_TOL, scale
        ces.append(want)
    # halving the embeddings moves the reference's CE past the tolerance:
    # the comparison above can see the cross path
    assert _rel(ces[1], ces[0]) > LOSS_TOL, ces


def _cross_attn_trees(cfg, tree):
    """The cross attention's {wq, wk, wv, wo, gate} subtrees of a numpy
    tree: a cross_attn block's "attn", an xdec block's "xattn"."""
    out = []
    for gi, pattern, _, _ in jtr.group_infos(cfg):
        for kind, bp in zip(pattern, tree["groups"][gi]):
            if kind in ("cross_attn", "xdec"):
                out.append(bp["attn" if kind == "cross_attn" else "xattn"])
    return out


def test_zero_gates_keep_cross_grads_zero(case):
    """Gates at 0: the backprop step's grads of the cross attention's
    weights are zero in both packages. Adam's first step moves an element
    by lr * g / (|g| + eps), so a leaf that stays put had a zero grad;
    the gate's own grad is tanh'(0) times the cross path's, and moves."""
    npp = jax.tree_util.tree_map(np.asarray, _gated(case.npp, 0.0))
    jb, tb = _batches(case)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    want, _, _ = _ref_bp_step(case.name)(jp, joptim.adam_init(jp), jb, 1)
    p0 = params_from_numpy(npp, "cpu")
    got, _, _ = ttrain.make_bp_train_step(case.tc, lr=1e-3)(
        p0, toptim.adam_init(p0), tb, 1)
    (before,) = _cross_attn_trees(case.jc, npp)
    for after in (jax.tree_util.tree_map(np.asarray, want),
                  params_to_numpy(got)):
        (cross,) = _cross_attn_trees(case.jc, after)
        for k in ("wq", "wk", "wv", "wo"):
            assert np.array_equal(cross[k], before[k]), k
        assert not np.array_equal(cross["gate"], before["gate"])
