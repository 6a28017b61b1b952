"""The port's training pieces against the reference on the CPU: Adam and
the LR cooldown, the FF losses, the wrong-label strategies, the epoch
permutation, and the weight streams of the three chapter trainers.

The random draws are the reference's own: ``JaxKey`` gives the port's
trainers the key interface of ``repro_torch.core.rng`` backed by
``jax.random``, so both packages consume the same permutations, wrong
labels and samples, and their weight streams can be compared at the
reference's ref-vs-fused gate (<= 1e-4 max-abs,
``tests/test_ff_dense_vjp.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import ff as jff, ff_mlp as jmlp
from repro_torch import optim as toptim
from repro_torch.core import ff as tff, ff_mlp as tmlp
from repro_torch.core.rng import TorchKey
from repro_torch.kernels import ff_dense_vjp, registry

WEIGHT_TOL = 1e-4


class JaxKey:
    """``core.rng``'s key interface backed by ``jax.random``: the port
    draws exactly the reference's numbers, handed over through numpy."""

    def __init__(self, key):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, data))

    def split(self, n):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def permutation(self, n):
        return torch.tensor(np.array(jax.random.permutation(self.key, n)))

    def randint(self, shape, low, high):
        return torch.tensor(np.array(
            jax.random.randint(self.key, tuple(shape), low, high)))

    def normal(self, shape):
        return torch.tensor(np.array(
            jax.random.normal(self.key, tuple(shape), jnp.float32)))

    def bernoulli(self, shape, p):
        return torch.tensor(np.array(
            jax.random.bernoulli(self.key, p, tuple(shape))))

    def categorical(self, logits):
        draw = jax.random.categorical(
            self.key, jnp.asarray(logits.detach().cpu().numpy()), axis=-1)
        return torch.tensor(np.array(draw)).to(logits.device)


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), tree)


def max_abs(a, b):
    la = jax.tree_util.tree_leaves(to_np(a))
    lb = jax.tree_util.tree_leaves(to_np(b))
    assert len(la) == len(lb)
    return max(float(np.abs(x - y).max()) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def test_adam_three_steps_match_reference():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((5, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = joptim.adam_init(jp)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    ts = toptim.adam_init(tp)
    for step in (1, 2, 3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in p.items()}
        lr = 0.01 * step
        jp, js = joptim.adam_update(jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, lr=lr, step=step)
        tp2, ts2 = toptim.adam_update(tp, {k: torch.tensor(v)
                                           for k, v in g.items()},
                                      ts, lr=lr, step=step)
        assert tp2 is tp and ts2 is ts            # updated in place
        for got, want in ((tp, jp), (ts, js)):
            for a, b in zip(jax.tree_util.tree_leaves(to_np(got)),
                            jax.tree_util.tree_leaves(to_np(want))):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("total,after", [(100, 0.5), (7, 0.3), (1, 0.5),
                                         (4, 1.0)])
def test_cooldown_lr_matches_reference(total, after):
    for epoch in range(total + 2):
        got = toptim.cooldown_lr(0.01, epoch, total, after)
        want = joptim.cooldown_lr(0.01, epoch, total, after)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# FF losses and wrong labels
# ---------------------------------------------------------------------------

def test_ff_losses_match_reference():
    rng = np.random.default_rng(1)
    # goodness spread wide, past softplus's linear switch at 20
    gp = (rng.standard_normal(16) * 15).astype(np.float32)
    gn = (rng.standard_normal(16) * 15).astype(np.float32)
    is_pos = (rng.random(16) > 0.5).astype(np.float32)
    y = np.maximum(rng.standard_normal((16, 9)), 0).astype(np.float32)
    pairs = [
        (tff.ff_loss(torch.tensor(gp), torch.tensor(gn), 2.0),
         jff.ff_loss(jnp.asarray(gp), jnp.asarray(gn), 2.0)),
        (tff.ff_loss_masked(torch.tensor(gp), torch.tensor(is_pos), 2.0),
         jff.ff_loss_masked(jnp.asarray(gp), jnp.asarray(is_pos), 2.0)),
        (tff.peer_norm_loss(torch.tensor(y)),
         jff.peer_norm_loss(jnp.asarray(y))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    x = torch.tensor([-30.0, 0.0, 25.0], requires_grad=True)
    sp = tff._softplus(x)
    np.testing.assert_allclose(sp.detach().numpy(), np.asarray(
        jax.nn.softplus(jnp.asarray([-30.0, 0.0, 25.0]))), rtol=1e-7)
    (g,) = torch.autograd.grad(sp.sum(), x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(
        lambda v: jnp.sum(jax.nn.softplus(v)))(jnp.asarray(
            [-30.0, 0.0, 25.0]))), rtol=1e-6)


def test_random_wrong_labels_are_the_references():
    y = np.random.default_rng(2).integers(0, 10, 500).astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jff.random_wrong_labels(key, jnp.asarray(y), 10))
    got = tff.random_wrong_labels(JaxKey(key), torch.tensor(y), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    own = tff.random_wrong_labels(TorchKey(4), torch.tensor(y), 10)
    assert bool((own != torch.tensor(y)).all())
    assert int(own.min()) >= 0 and int(own.max()) <= 9


def test_adaptive_wrong_labels_argmax_and_samples_are_the_references():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((300, 10)).astype(np.float32)
    y = rng.integers(0, 10, 300).astype(np.int32)
    want = np.asarray(jff.adaptive_wrong_labels(jnp.asarray(scores),
                                                jnp.asarray(y)))
    got = tff.adaptive_wrong_labels(torch.tensor(scores), torch.tensor(y))
    np.testing.assert_array_equal(got.numpy(), want)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jff.adaptive_wrong_labels(
        jnp.asarray(scores), jnp.asarray(y), key=key))
    got = tff.adaptive_wrong_labels(torch.tensor(scores), torch.tensor(y),
                                    key=JaxKey(key))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("key_kind", ["jax", "torch"])
def test_adaptive_wrong_labels_moments_exclude_true_column(key_kind):
    """tests/test_ff_core.py's regression, through the port: the true
    label's score is not part of the z-score moments, so the sampling
    distribution over wrong labels is e^(z2 - z1) = e^2 ~ 7.4."""
    key = JaxKey(0) if key_kind == "jax" else TorchKey(0)
    y = torch.zeros(4096, dtype=torch.int32)
    base = torch.tensor([[10.0, 1.0, 2.0]]).repeat(4096, 1)
    spiked = base.clone()
    spiked[:, 0] = 1000.0
    lab_base = tff.adaptive_wrong_labels(base, y, key=key)
    lab_spiked = tff.adaptive_wrong_labels(spiked, y, key=key)
    assert torch.equal(lab_base, lab_spiked)
    counts = torch.bincount(lab_base.long(), minlength=3)
    assert int(counts[0]) == 0
    assert 5.0 < float(counts[2]) / float(counts[1]) < 11.0


# ---------------------------------------------------------------------------
# Epoch permutations (tests/test_tail_batches.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch", [(100, 64), (130, 64), (640, 64),
                                     (65, 64), (64, 64), (63, 64),
                                     (20, 64)])
def test_epoch_perm_wraps_like_the_reference(n, batch):
    key = jax.random.PRNGKey(0)
    want = np.asarray(jmlp._epoch_perm(key, 3, n, batch))
    got = tmlp._epoch_perm(JaxKey(key), 3, n, batch)
    assert tmlp._num_batches(n, batch) == jmlp._num_batches(n, batch)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    own = tmlp._epoch_perm(TorchKey(0), 3, n, batch)
    assert own.shape == (tmlp._num_batches(n, batch) * batch,)
    assert set(own.tolist()) == set(range(n))


def test_torch_key_draws_are_pure_functions_of_the_path():
    a, b = TorchKey(7), TorchKey(7)
    assert torch.equal(a.fold_in(3).permutation(50),
                       b.fold_in(3).permutation(50))
    assert not torch.equal(a.fold_in(3).permutation(50),
                           a.fold_in(4).permutation(50))
    s1, s2 = a.split(2)
    assert not torch.equal(s1.normal((8,)), s2.normal((8,)))
    assert torch.equal(s1.normal((8,)), b.split(2)[0].normal((8,)))
    assert a.fold_in(1).path != a.split(2)[1].path
    r = a.randint((1000,), 1, 10)
    assert int(r.min()) >= 1 and int(r.max()) <= 9


# ---------------------------------------------------------------------------
# Chapter trainers: weight streams against the reference
# ---------------------------------------------------------------------------

@pytest.fixture()
def fused_cpu_impl(monkeypatch):
    """An ``impl`` that routes ``ops.ff_dense`` through the autograd
    Functions on the CPU (the kernels' plain versions inside), so the
    trainers' fused path runs here too."""
    def fused(x, w, b, *, norm):
        fn = (ff_dense_vjp.ff_dense_norm_vjp if norm
              else ff_dense_vjp.ff_dense_vjp)
        return fn(x, w, b)
    monkeypatch.setitem(registry.ff_dense._entries, "fused_cpu",
                        registry.KernelImpl("fused_cpu", fused,
                                            lambda platform: False))
    return "fused_cpu"


def _normed(rng, n, K):
    """Layer inputs as the trainers see them: length-normalized rows
    (``ff_mlp._norm`` / the ``norm=True`` epilogue). Raw N(0, 1) rows
    make a few Adam updates hinge on gradients near eps = 1e-8, where
    the two packages' f32 summation orders alone move a weight by more
    than the gate."""
    x = rng.standard_normal((n, K))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _layer(rng, K, N):
    return {"w": (rng.standard_normal((K, N)) * K ** -0.5).astype(
        np.float32), "b": np.zeros(N, np.float32)}


def _streams(run_ref, run_port, lp0, chapters=2):
    """Runs both packages' trainers chapter by chapter from the same
    numpy start; returns the per-chapter max-abs differences of the
    first two trees (params and Adam state, or layer and head)."""
    jstate = jax.tree_util.tree_map(jnp.asarray, lp0)
    tstate = jax.tree_util.tree_map(torch.tensor, lp0)
    base = jax.random.PRNGKey(11)
    errs = []
    for c in range(chapters):
        jstate = run_ref(jstate, jax.random.fold_in(base, c))
        tstate = run_port(tstate, JaxKey(base).fold_in(c))
        errs.append(max_abs(tuple(tstate[:2]), tuple(jstate[:2])))
    return errs


@pytest.mark.parametrize("impl", ["ref", "fused"])
def test_train_layer_chapter_stream_matches_reference(impl, fused_cpu_impl):
    K, N, n = 333, 257, 256
    rng = np.random.default_rng(6)
    xp, xn = _normed(rng, n, K), _normed(rng, n, K)
    lrs = np.full(2, 0.01, np.float32)
    timpl = fused_cpu_impl if impl == "fused" else "auto"
    before = ff_dense_vjp.LAUNCHES.total

    def run_ref(state, key):
        lp, opt = jmlp.train_layer_chapter(
            state[0], state[1], jnp.asarray(xp), jnp.asarray(xn),
            jnp.asarray(lrs), key, batch=64, epochs=2, theta=2.0,
            peer_w=0.0, impl="ref")
        return lp, opt

    def run_port(state, key):
        return tmlp.train_layer_chapter(
            state[0], state[1], torch.tensor(xp), torch.tensor(xn),
            torch.tensor(lrs), key, batch=64, epochs=2, theta=2.0,
            peer_w=0.0, impl=timpl)

    lp0 = _layer(rng, K, N)
    start = (lp0, {"m": jax.tree_util.tree_map(np.zeros_like, lp0),
                   "v": jax.tree_util.tree_map(np.zeros_like, lp0)})
    errs = _streams(run_ref, run_port, start)
    assert max(errs) <= WEIGHT_TOL, errs
    assert ff_dense_vjp.LAUNCHES.total == before   # the CPU launches nothing


@pytest.mark.parametrize("impl", ["ref", "fused"])
def test_train_layer_chapter_perf_opt_stream_matches_reference(
        impl, fused_cpu_impl):
    K, N, n = 333, 257, 256
    rng = np.random.default_rng(7)
    x = _normed(rng, n, K)
    y = rng.integers(0, 10, n).astype(np.int32)
    lrs = np.full(2, 0.01, np.float32)
    timpl = fused_cpu_impl if impl == "fused" else "auto"

    def run_ref(state, key):
        return jmlp.train_layer_chapter_perf_opt(
            *state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lrs), key,
            batch=64, epochs=2, impl="ref")

    def run_port(state, key):
        return tmlp.train_layer_chapter_perf_opt(
            *state, torch.tensor(x), torch.tensor(y), torch.tensor(lrs),
            key, batch=64, epochs=2, impl=timpl)

    lp0 = _layer(rng, K, N)
    head0 = {"w": (rng.standard_normal((N, 10)) * N ** -0.5).astype(
        np.float32), "b": np.zeros(10, np.float32)}
    zeros = lambda t: {"m": jax.tree_util.tree_map(np.zeros_like, t),  # noqa
                       "v": jax.tree_util.tree_map(np.zeros_like, t)}
    start = (lp0, head0, zeros(lp0), zeros(head0))
    errs = _streams(run_ref, run_port, start)
    assert max(errs) <= WEIGHT_TOL, errs


def test_train_head_chapter_stream_matches_reference():
    rng = np.random.default_rng(8)
    n, D = 70, 24                      # 70 % 32 != 0: the wrapped tail
    feats = rng.standard_normal((n, D)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    lrs = np.full(2, 0.01, np.float32)
    head0 = {"w": (rng.standard_normal((D, 10)) * 0.1).astype(np.float32),
             "b": np.zeros(10, np.float32)}

    def run_ref(state, key):
        return jmlp.train_head_chapter(
            state[0], state[1], jnp.asarray(feats), jnp.asarray(y),
            jnp.asarray(lrs), key, batch=32, epochs=2)

    def run_port(state, key):
        return tmlp.train_head_chapter(
            state[0], state[1], torch.tensor(feats), torch.tensor(y),
            torch.tensor(lrs), key, batch=32, epochs=2)

    start = (head0, {"m": jax.tree_util.tree_map(np.zeros_like, head0),
                     "v": jax.tree_util.tree_map(np.zeros_like, head0)})
    errs = _streams(run_ref, run_port, start)
    assert max(errs) <= WEIGHT_TOL, errs


def test_fwd_norm_is_the_normalized_layer_apply():
    """The inter-layer hand-off is ``_norm(layer_apply(...))`` (its
    norm epilogue sums y^2 then takes sqrt, ``_norm`` takes
    ``vector_norm``: equal within f32 rounding), and the reference's
    hand-off likewise."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((100, 333)).astype(np.float32)
    lp = {"w": (rng.standard_normal((333, 257)) * 0.05).astype(np.float32),
          "b": np.full(257, 0.1, np.float32)}
    tlp = {k: torch.tensor(v) for k, v in lp.items()}
    got = tmlp.fwd_norm(tlp, torch.tensor(x))
    np.testing.assert_allclose(
        got.numpy(), tmlp._norm(tmlp.layer_apply(tlp, torch.tensor(x))),
        rtol=1e-5, atol=1e-7)
    want = jmlp.fwd_norm(jax.tree_util.tree_map(jnp.asarray, lp),
                         jnp.asarray(x), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_trainers_update_in_place_and_move_the_weights():
    rng = np.random.default_rng(9)
    lp = {"w": torch.tensor(_layer(rng, 32, 16)["w"]), "b": torch.zeros(16)}
    w0 = lp["w"].clone()
    opt = toptim.adam_init(lp)
    x = torch.tensor(rng.standard_normal((20, 32)).astype(np.float32))
    out, _ = tmlp.train_layer_chapter(lp, opt, x, -x, torch.full((2,), 0.01),
                                      TorchKey(0), batch=64, epochs=2,
                                      theta=2.0)
    assert out["w"] is lp["w"] and not torch.equal(lp["w"], w0)
    assert bool(torch.isfinite(lp["w"]).all())
