"""The port's ``ff_dense`` backward on the CPU: ``ff_dense_bwd_plain``
against the reference's Pallas ``ff_dense_bwd`` (interpret mode, as
``tests/test_ff_dense_vjp.py`` runs it), the ``FFDense``/``FFDenseNorm``
gradients against ``jax.grad`` through the reference's
``ff_dense_vjp``/``ff_dense_norm_vjp`` under that test's two losses (f32,
and bf16 at the reference's bf16 tolerance), the dead-row case, the
wrapper's checks, and the ``ops`` dispatch. The CUDA kernel itself is
held against its plain version on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ff as jff
from repro.kernels.ff_dense_vjp import (
    ff_dense_bwd as pallas_ff_dense_bwd, ff_dense_norm_vjp as j_norm_vjp,
    ff_dense_vjp as j_vjp)
from repro_torch.core import ff as tff
from repro_torch.kernels import ff_dense as fwd_kernel, ff_dense_vjp, ops

# fused grads: the reference test's own tolerance
RTOL, ATOL = 1e-4, 1e-6
# the backward's three products at random cotangents, scaled by max|ref|:
# f32 sums of <= 2000 terms in two summation orders
BWD_TOL = 1e-5


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    b = np.full(N, 0.1, np.float32)
    return rng, x, w, b


def _scaled_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("M,K,N", [(100, 333, 257), (64, 784, 512),
                                   (16, 64, 64)])
def test_bwd_plain_matches_reference_pallas_bwd(M, K, N):
    rng, x, w, b = _operands(M, K, N, seed=M + K + N)
    y = np.maximum(x @ w + b, 0).astype(np.float32)
    dy_out = rng.standard_normal((M, N)).astype(np.float32)
    dg = rng.standard_normal(M).astype(np.float32)
    want = pallas_ff_dense_bwd(*(jnp.asarray(a) for a in (x, w, y, dy_out,
                                                           dg)))
    got = ff_dense_vjp.ff_dense_bwd_plain(
        *(torch.tensor(a) for a in (x, w, y, dy_out, dg)))
    for t, j, name in zip(got, want, ("dx", "dw", "db")):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, name
        assert _scaled_err(t.numpy(), j) <= BWD_TOL, name


def test_bwd_drops_a_nan_dg_on_a_dead_row():
    """The mask is a select: a NaN dg on a row whose y is all zero (the
    norm fold's 0/0) must not reach any output, in both packages."""
    rng, x, w, b = _operands(16, 64, 64, seed=1)
    y = np.maximum(x @ w + b, 0).astype(np.float32)
    y[3] = 0.0
    dy_out = rng.standard_normal((16, 64)).astype(np.float32)
    dg = rng.standard_normal(16).astype(np.float32)
    dg[3] = np.nan
    want = pallas_ff_dense_bwd(*(jnp.asarray(a) for a in (x, w, y, dy_out,
                                                           dg)))
    got = ff_dense_vjp.ff_dense_bwd(
        *(torch.tensor(a) for a in (x, w, y, dy_out, dg)))
    for t, j in zip(got, want):
        assert bool(torch.isfinite(t).all())
        assert _scaled_err(t.numpy(), j) <= BWD_TOL
    assert bool((got[0][3] == 0).all())


def _stacked_loss(xp):
    """tests/test_ff_dense_vjp.py::_stacked_ff_loss in either package."""
    def loss(apply_fn, lp, xb, theta, peer_w):
        y, g = apply_fn(xb, lp["w"], lp["b"])
        g = g / y.shape[-1]
        half = xb.shape[0] // 2
        out = xp.ff_loss(g[:half], g[half:], theta)
        return out + peer_w * xp.peer_norm_loss(y[:half])
    return loss


def _normed_loss(tanh):
    """tests/test_ff_dense_vjp.py::_normed_loss in either package."""
    def loss(apply_fn, lp, xb, v):
        yn, g = apply_fn(xb, lp["w"], lp["b"])
        return ((yn @ v) ** 2).mean() + tanh(g).mean()
    return loss


def _torch_grads(loss, lp, x, *args):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in lp.items()}
    tx = torch.tensor(x, requires_grad=True)
    targs = [torch.tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    gw, gb, gx = torch.autograd.grad(loss(leaves, tx, *targs),
                                     [leaves["w"], leaves["b"], tx])
    return gw.numpy(), gb.numpy(), gx.numpy()


def _assert_grads(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("M,K,N", [(100, 333, 257), (64, 784, 512),
                                   (100, 784, 2000), (16, 64, 64)])
@pytest.mark.parametrize("peer_w", [0.0, 0.3])
def test_ffdense_grads_match_reference_custom_vjp(M, K, N, peer_w):
    """The peer term drives the y cotangent, the FF loss the g one."""
    _, x, w, b = _operands(M, K, N, seed=M * N + K)
    lp = {"w": w, "b": b}
    jloss = _stacked_loss(jff)
    tloss = _stacked_loss(tff)
    jg, jgx = jax.grad(
        lambda p, xb: jloss(lambda *a: j_vjp(*a, True), p, xb, 2.0,
                            peer_w), argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x))
    got = _torch_grads(lambda p, xb: tloss(ff_dense_vjp.ff_dense_vjp, p, xb,
                                           2.0, peer_w), lp, x)
    _assert_grads(got, (jg["w"], jg["b"], jgx))


@pytest.mark.parametrize("M,K,N", [(100, 333, 257), (16, 64, 64)])
def test_ffdensenorm_grads_match_reference_custom_vjp(M, K, N):
    rng, x, w, b = _operands(M, K, N, seed=M + N)
    v = rng.standard_normal(N).astype(np.float32)
    lp = {"w": w, "b": b}
    jg, jgx = jax.grad(
        lambda p, xb: _normed_loss(jnp.tanh)(
            lambda *a: j_norm_vjp(*a, True), p, xb, jnp.asarray(v)),
        argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x))
    got = _torch_grads(
        lambda p, xb, tv: _normed_loss(torch.tanh)(
            ff_dense_vjp.ff_dense_norm_vjp, p, xb, tv), lp, x, v)
    _assert_grads(got, (jg["w"], jg["b"], jgx))


# bf16: the reference's ff_dense tolerance in bf16 (tests/test_kernels.py),
# max|got - ref| / max|ref|, 5x that for a gradient that only g drives
BF16_TOL = 3e-2
BF16_SHAPES = [(64, 784, 512), (100, 333, 257)]


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch_bf16_grads(loss, lp, x, *args):
    leaves = {k: torch.tensor(v).bfloat16().requires_grad_(True)
              for k, v in lp.items()}
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    got = torch.autograd.grad(loss(leaves, tx, *args),
                              [leaves["w"], leaves["b"], tx])
    assert all(t.dtype == torch.bfloat16 for t in got)
    return [t.float().numpy() for t in got]


def _assert_bf16_grads(got, want, tol):
    for a, b, name in zip(got, want, ("dw", "db", "dx")):
        assert b.dtype == jnp.bfloat16, name
        assert _scaled_err(a, np.asarray(b, np.float32)) <= tol, name


@pytest.mark.parametrize("M,K,N", BF16_SHAPES)
def test_bwd_plain_bf16_matches_reference_pallas_bwd(M, K, N):
    """bf16 operands, f32 dg: both compute in f32; dx and dw in bf16,
    db in f32."""
    rng, x, w, b = _operands(M, K, N, seed=M + K + N)
    y = np.maximum(x @ w + b, 0).astype(np.float32)
    dy_out = rng.standard_normal((M, N)).astype(np.float32)
    dg = rng.standard_normal(M).astype(np.float32)
    want = pallas_ff_dense_bwd(_bf16(x), _bf16(w), _bf16(y), _bf16(dy_out),
                               jnp.asarray(dg))
    got = ff_dense_vjp.ff_dense_bwd(
        *(torch.tensor(a).bfloat16() for a in (x, w, y, dy_out)),
        torch.tensor(dg))
    for t, j, name in zip(got, want, ("dx", "dw", "db")):
        assert str(t.dtype)[6:] == str(j.dtype), name
        assert _scaled_err(t.float().numpy(), np.asarray(j, np.float32)) \
            <= BF16_TOL, name


@pytest.mark.parametrize("M,K,N", BF16_SHAPES)
@pytest.mark.parametrize("peer_w", [0.0, 0.3])
def test_ffdense_bf16_grads_match_reference_custom_vjp(M, K, N, peer_w):
    """The bf16 layer's grads against ``jax.grad`` through the
    reference's bf16 custom_vjp; with peer_w 0 the loss reads g alone."""
    _, x, w, b = _operands(M, K, N, seed=M * N + K)
    lp = {"w": w, "b": b}
    jg, jgx = jax.grad(
        lambda p, xb: _stacked_loss(jff)(lambda *a: j_vjp(*a, True), p, xb,
                                         2.0, peer_w), argnums=(0, 1))(
        jax.tree_util.tree_map(_bf16, lp), _bf16(x))
    got = _torch_bf16_grads(
        lambda p, xb: _stacked_loss(tff)(ff_dense_vjp.ff_dense_vjp, p, xb,
                                         2.0, peer_w), lp, x)
    _assert_bf16_grads(got, (jg["w"], jg["b"], jgx),
                       BF16_TOL * (5 if peer_w == 0.0 else 1))


@pytest.mark.parametrize("M,K,N", BF16_SHAPES)
def test_ffdensenorm_bf16_grads_match_reference_custom_vjp(M, K, N):
    rng, x, w, b = _operands(M, K, N, seed=M + N)
    v = rng.standard_normal(N).astype(np.float32)
    lp = {"w": w, "b": b}
    jg, jgx = jax.grad(
        lambda p, xb: _normed_loss(jnp.tanh)(
            lambda *a: j_norm_vjp(*a, True), p, xb, _bf16(v)),
        argnums=(0, 1))(jax.tree_util.tree_map(_bf16, lp), _bf16(x))
    got = _torch_bf16_grads(
        lambda p, xb: _normed_loss(torch.tanh)(
            ff_dense_vjp.ff_dense_norm_vjp, p, xb,
            torch.tensor(v).bfloat16()), lp, x)
    _assert_bf16_grads(got, (jg["w"], jg["b"], jgx), BF16_TOL)


@pytest.mark.parametrize("norm", [False, True])
def test_dead_rows_give_finite_zero_grads(norm):
    """tests/test_ff_dense_vjp.py::test_norm_epilogue_dead_rows_no_nan
    through the port's Functions: every unit dead, so the norm fold's
    dg' is 0/0 = NaN on every row, and the select must drop it."""
    x = torch.zeros(4, 64, requires_grad=True)
    w = torch.zeros(64, 128, requires_grad=True)
    b = torch.full((128,), -1.0, requires_grad=True)
    fn = ff_dense_vjp.ff_dense_norm_vjp if norm else ff_dense_vjp.ff_dense_vjp
    y, g = fn(x, w, b)
    assert bool((y == 0).all()) and bool((g == 0).all())
    loss = (y @ torch.ones(128)).pow(2).mean() + torch.tanh(g).mean()
    for grad in torch.autograd.grad(loss, [x, w, b]):
        assert bool(torch.isfinite(grad).all())
        assert bool((grad == 0).all())


@pytest.mark.parametrize("norm", [False, True])
def test_ops_auto_on_cpu_launches_neither_kernel(norm):
    _, x, w, b = _operands(16, 64, 64, seed=2)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    before = (fwd_kernel.LAUNCHES.total, ff_dense_vjp.LAUNCHES.total)
    y, g = ops.ff_dense(*leaves, norm=norm)
    torch.autograd.grad((y.sum() + g.sum()), leaves)
    fn = ff_dense_vjp.ff_dense_norm_vjp if norm else ff_dense_vjp.ff_dense_vjp
    fn(*leaves)[1].sum().backward()
    assert (fwd_kernel.LAUNCHES.total, ff_dense_vjp.LAUNCHES.total) == before


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    rng, x, w, b = _operands(8, 16, 12, seed=3)
    args = [torch.tensor(a) for a in (
        x, w, np.maximum(x @ w + b, 0).astype(np.float32),
        rng.standard_normal((8, 12)).astype(np.float32),
        rng.standard_normal(8).astype(np.float32))]
    for a, p in zip(ff_dense_vjp.ff_dense_bwd(*args),
                    ff_dense_vjp.ff_dense_bwd_plain(*args)):
        assert torch.equal(a, p)


@pytest.mark.parametrize("case,exc,match", [
    ("bf16", TypeError, "and dg float32"),
    ("f64", TypeError, "all float32 or all bfloat16"),
    ("mixed", TypeError, "all float32 or all bfloat16"),
    ("k_mismatch", ValueError, "shape mismatch"),
    ("dg_shape", ValueError, "shape mismatch"),
    ("rank", ValueError, "expects x"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(case, exc,
                                                           match):
    x, w = torch.ones(4, 8), torch.ones(8, 6)
    y, dyo, dg = torch.ones(4, 6), torch.ones(4, 6), torch.ones(4)
    args = {
        "bf16": (x.bfloat16(), w.bfloat16(), y.bfloat16(), dyo.bfloat16(),
                 dg.bfloat16()),
        "f64": (x.double(), w, y, dyo, dg),
        "mixed": (x.bfloat16(), w, y, dyo, dg),
        "k_mismatch": (x, torch.ones(7, 6), y, dyo, dg),
        "dg_shape": (x, w, y, dyo, torch.ones(5)),
        "rank": (x[0], w, y, dyo, dg),
        "meta_device": tuple(t.to("meta") for t in (x, w, y, dyo, dg)),
    }[case]
    with pytest.raises(exc, match=match):
        ff_dense_vjp.ff_dense_bwd(*args)


# grad_x's split of dx's reduction over N (csrc/ff_dense_bwd.cu): the
# training shapes of chip_smoke.py, its ragged checks, and edge sizes.
TRAIN_SHAPES = [(128, 784, 2000), (128, 2000, 2000), (64, 784, 2000),
                (64, 2000, 2000)]
SPLIT_SHAPES = TRAIN_SHAPES + [(100, 333, 257), (16, 64, 64), (1, 1, 1),
                               (640, 2000, 2000), (128, 2000, 17),
                               (7, 5, 3000)]


def _slices(M, K, N):
    S, L = ff_dense_vjp._grad_x_split(M, K, N)
    return [(s * L, min((s + 1) * L, N)) for s in range(S)], L


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_grad_x_split_slices_cover_n_exactly_and_are_non_empty(M, K, N):
    slices, L = _slices(M, K, N)
    assert L % ff_dense_vjp.GRAD_X_BK == 0
    assert slices[0][0] == 0 and slices[-1][1] == N
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("M,K,N", TRAIN_SHAPES)
def test_grad_x_split_fills_the_card_at_training_shapes(M, K, N):
    S, _ = ff_dense_vjp._grad_x_split(M, K, N)
    blocks = (-(-K // ff_dense_vjp.GRAD_X_BN) * -(-M // ff_dense_vjp.GRAD_X_BM)
              * S)
    assert blocks >= 132   # the H100's SMs


def test_grad_x_split_is_deterministic():
    first = [ff_dense_vjp._grad_x_split(*s) for s in SPLIT_SHAPES]
    assert first == [ff_dense_vjp._grad_x_split(*s) for s in SPLIT_SHAPES]
    assert first[1] == (8, 256)   # (128, 2000, 2000): 32 x 8 = 256 blocks


@pytest.mark.parametrize("M,K,N", [(128, 784, 2000), (100, 333, 257),
                                   (16, 64, 64), (64, 200, 1000)])
def test_split_n_fixed_order_sum_matches_plain(M, K, N):
    """dx as the kernel forms it: one partial per slice of N, summed in
    slice order, against ff_dense_bwd_plain."""
    rng, x, w, b = _operands(M, K, N, seed=M + 2 * K + N)
    y = np.maximum(x @ w + b, 0).astype(np.float32)
    dy_out = rng.standard_normal((M, N)).astype(np.float32)
    dg = rng.standard_normal(M).astype(np.float32)
    tx, tw, ty, tdo, tdg = (torch.tensor(a) for a in (x, w, y, dy_out, dg))
    dy = torch.where(ty > 0, tdo + 2.0 * ty * tdg[:, None],
                     torch.zeros(()))
    slices, _ = _slices(M, K, N)
    parts = [dy[:, lo:hi] @ tw[:, lo:hi].T for lo, hi in slices]
    dx = parts[0]
    for part in parts[1:]:
        dx = dx + part
    want = ff_dense_vjp.ff_dense_bwd_plain(tx, tw, ty, tdo, tdg)[0]
    assert _scaled_err(dx.numpy(), want.numpy()) <= 1e-6
