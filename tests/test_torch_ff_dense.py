"""The port's ``ff_dense`` module on the CPU: its plain version and
oracles against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and jnp oracles, the wrapper's CPU
behaviour and operand checks, the ``ops`` dispatch contract, the
kernel build's lookup and cache key, the kernel's split of K and block
width, its 3xTF32 split-K arithmetic emulated in its own order against
the Pallas kernel, and that arithmetic under a model of the tensor
cores' truncating sums. The CUDA kernel itself is held against its plain
version on the card by ``chip_smoke.py``."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ff_dense import ff_dense as pallas_ff_dense
from repro_torch.kernels import _build, ff_dense as kernel, ops, ref
from tf32_emulation import mm_tf32, tf32

SHAPES = [(64, 784, 512), (100, 333, 257), (16, 64, 64)]
# y tolerance per dtype (tests/test_kernels.py); g at 5x
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(M, K, N, dtype, *, seed=0, dead_row=False):
    """The same operands for both packages: numpy from a seed, cast to
    ``dtype`` by JAX, handed to torch bit for bit."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    if dead_row:
        x[0] = 0.0
        b = -(np.abs(b) + 0.1)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w, b)]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [False, True])
def test_plain_matches_reference_pallas_kernel(M, K, N, dtype, norm):
    (jx, jw, jb), (tx, tw, tb) = _inputs(M, K, N, dtype)
    y, g = pallas_ff_dense(jx, jw, jb, norm=norm)
    yp, gp = kernel.ff_dense_plain(tx, tw, tb, norm=norm)
    assert yp.dtype == getattr(torch, dtype) and gp.dtype == torch.float32
    _assert_close(yp, y, TOL[dtype])
    _assert_close(gp, g, 5 * TOL[dtype])


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [False, True])
def test_oracles_match_reference_oracles(M, K, N, dtype, norm):
    (jx, jw, jb), (tx, tw, tb) = _inputs(M, K, N, dtype, seed=1)
    jfn = jref.ff_dense_norm_ref if norm else jref.ff_dense_ref
    tfn = ref.ff_dense_norm_ref if norm else ref.ff_dense_ref
    y, g = jfn(jx, jw, jb)
    yp, gp = tfn(tx, tw, tb)
    _assert_close(yp, y, TOL[dtype])
    _assert_close(gp, g, 5 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [False, True])
def test_dead_row_gives_zeros_not_nan(dtype, norm):
    _, (x, w, b) = _inputs(32, 784, 256, dtype, seed=2, dead_row=True)
    y, g = kernel.ff_dense(x, w, b, norm=norm)
    assert float(g[0]) == 0.0 and bool((y[0] == 0).all())
    assert bool(torch.isfinite(y.float()).all()) and bool((g[1:] > 0).any())


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    _, (x, w, b) = _inputs(16, 64, 64, "float32")
    before = kernel.LAUNCHES.total
    for norm in (False, True):
        y, g = kernel.ff_dense(x, w, b, norm=norm)
        yp, gp = kernel.ff_dense_plain(x, w, b, norm=norm)
        assert torch.equal(y, yp) and torch.equal(g, gp)
    assert kernel.LAUNCHES.total == before


@pytest.mark.parametrize("case,exc,match", [
    ("k_mismatch", ValueError, "shape mismatch"),
    ("b_mismatch", ValueError, "shape mismatch"),
    ("rank", ValueError, "expects x"),
    ("mixed_dtype", TypeError, "all float32 or all"),
    ("float64", TypeError, "all float32 or all"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    x, w, b = torch.ones(4, 8), torch.ones(8, 6), torch.ones(6)
    args = {
        "k_mismatch": (x, torch.ones(7, 6), b),
        "b_mismatch": (x, w, torch.ones(5)),
        "rank": (x[0], w, b),
        "mixed_dtype": (x, w.bfloat16(), b),
        "float64": (x.double(), w.double(), b.double()),
        "meta_device": (x.to("meta"), w.to("meta"), b.to("meta")),
    }[case]
    with pytest.raises(exc, match=match):
        kernel.ff_dense(*args)


def test_ops_unknown_impl_lists_choices():
    _, (x, w, b) = _inputs(16, 64, 64, "float32")
    with pytest.raises(ValueError, match="auto | cuda | ref"):
        ops.ff_dense(x, w, b, impl="nope")


@pytest.mark.parametrize("norm", [False, True])
def test_ops_cuda_impl_on_a_cpu_tensor_raises(norm):
    _, (x, w, b) = _inputs(16, 64, 64, "float32")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.ff_dense(x, w, b, impl="cuda", norm=norm)


@pytest.mark.parametrize("norm", [False, True])
def test_ops_auto_on_a_cpu_tensor_is_ref(norm):
    _, (x, w, b) = _inputs(16, 64, 64, "float32")
    before = kernel.LAUNCHES.total
    y, g = ops.ff_dense(x, w, b, norm=norm)
    fn = ref.ff_dense_norm_ref if norm else ref.ff_dense_ref
    yr, gr = fn(x, w, b)
    assert torch.equal(y, yr) and torch.equal(g, gr)
    assert kernel.LAUNCHES.total == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_nvcc_is_found_on_path_then_cuda_home(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: "/elsewhere/bin/nvcc")
    assert _build.find_nvcc() == "/elsewhere/bin/nvcc"
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(tmp_path / "bin" / "nvcc")


def test_library_is_keyed_by_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "ff_dense.cu"
    src.write_bytes((_build.CSRC / "ff_dense.cu").read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    assert first.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build.library_path() != first
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# gemm_split's cut of the reduction over K (csrc/ff_dense.cu): the
# training and serving shapes of chip_smoke.py, its ragged checks, and
# edge sizes.
TRAIN_SHAPES = [(128, 784, 2000), (128, 2000, 2000), (64, 784, 2000),
                (64, 2000, 2000)]
SERVING_SHAPES = [(640, 784, 2000), (640, 2000, 2000)]
SPLIT_SHAPES = TRAIN_SHAPES + SERVING_SHAPES + [
    (100, 333, 257), (16, 64, 64), (1, 1, 1), (128, 17, 2000),
    (7, 5000, 3)]


def _k_slices(M, K, N):
    S, L = kernel._fwd_split(M, K, N)
    return [(s * L, min((s + 1) * L, K)) for s in range(S)], L


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_fwd_split_slices_cover_k_exactly_and_are_non_empty(M, K, N):
    slices, L = _k_slices(M, K, N)
    assert L % kernel.FWD_BK == 0
    assert slices[0][0] == 0 and slices[-1][1] == K
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))


@pytest.mark.parametrize("M,K,N", TRAIN_SHAPES + SERVING_SHAPES)
def test_fwd_split_fills_the_card_at_training_and_serving_shapes(M, K, N):
    S, _ = kernel._fwd_split(M, K, N)
    blocks = -(-N // kernel._fwd_tile(M, N)) * -(-M // kernel.FWD_BM) * S
    assert blocks >= 200   # 132 SMs, two blocks each fit


def test_fwd_split_is_deterministic():
    first = [kernel._fwd_split(*s) for s in SPLIT_SHAPES]
    assert first == [kernel._fwd_split(*s) for s in SPLIT_SHAPES]
    assert first[1] == (8, 256)   # (128, 2000, 2000): 32 tiles x 8 slices
    assert first[5][0] == 3       # (640, 2000, 2000): 80 tiles x 3


@pytest.mark.parametrize("M,K,N", TRAIN_SHAPES + SERVING_SHAPES)
def test_fwd_tile_is_wide_only_where_narrow_tiles_fill_the_card(M, K, N):
    bn = kernel._fwd_tile(M, N)
    assert bn in kernel.FWD_BNS
    assert bn == (128 if M == 640 else 64)


def test_tf32_rounding_is_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10   # TF32 keeps 10 mantissa bits
    t = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0, 2.0 ** -130])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0,
                         2.0 ** -130])
    assert torch.equal(tf32(t), want)
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11


def _split_k_emulation(x, w, b, norm, products=3, *, L=None, **mm):
    """csrc/ff_dense.cu's arithmetic: each K slice of ``_fwd_split`` (or
    of depth ``L``) multiplied as 3xTF32 (``products=3``; bf16 operands
    are exact in TF32 and take one product) into its own partial, the
    partials summed in slice order, then bias, relu, g and the norm
    divide. ``mm`` goes to ``mm_tf32`` (its accumulation model)."""
    M, K = x.shape
    L = L or kernel._fwd_split(M, K, w.shape[1])[1]
    if x.dtype == torch.bfloat16:
        products = 1
    acc = None
    for s in range(-(-K // L)):
        part = mm_tf32(x[:, s * L:(s + 1) * L], w[s * L:(s + 1) * L],
                       products, **mm)
        acc = part if acc is None else acc + part
    y = torch.relu(acc + b.float())
    g = torch.sum(y * y, dim=1)
    y = y.to(x.dtype)
    if norm:
        y = (y.float() / (torch.sqrt(g)[:, None] + kernel.NORM_EPS)).to(
            x.dtype)
    return y, g


@pytest.mark.parametrize("M,K,N", [(128, 784, 2000), (100, 333, 257),
                                   (16, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [False, True])
def test_3xtf32_split_k_arithmetic_matches_reference_pallas_kernel(
        M, K, N, dtype, norm, request):
    """The kernel's arithmetic at the reference's tolerances (y 2e-5, g
    1e-4 in f32). One TF32 product instead of three is recorded (printed
    and kept in the test's user properties), not gated: it shows what
    3xTF32 buys. On the CPU these inputs read 2.9e-4 to 3.5e-4 scaled y
    error with one product, 15x the f32 gate, and 2.5e-7 to 7.3e-7 with
    three."""
    (jx, jw, jb), (tx, tw, tb) = _inputs(M, K, N, dtype, seed=4)
    y, g = pallas_ff_dense(jx, jw, jb, norm=norm)
    ye, ge = _split_k_emulation(tx, tw, tb, norm)
    _assert_close(ye, y, TOL[dtype])
    _assert_close(ge, g, 5 * TOL[dtype])
    if dtype == "float32":
        y1, g1 = _split_k_emulation(tx, tw, tb, norm, products=1)
        want = torch.tensor(np.asarray(y, np.float32))
        readings = {f"y_err_{n}xtf32": float((e - want).abs().max()
                                             / want.abs().max())
                    for n, e in ((1, y1), (3, ye))}
        request.node.user_properties.extend(readings.items())
        print(f"ff_dense {(M, K, N)} norm={norm}: scaled y error {readings}")


@pytest.mark.parametrize("M,K,N", [(640, 2000, 2000), (128, 2000, 2000)])
def test_fresh_fragment_bounds_the_cards_truncating_accumulation(M, K, N,
                                                                 request):
    """The tensor cores truncate each mma's sum toward zero
    (tf32_emulation's ``rz`` model). Chained into one accumulator over a
    slice, that bias grows with the slice's depth: over the 1024-deep
    slices the serving M = 640 took before, the model reads 1.0e-5 scaled
    y error and 1.6e-5 g on 32 rows, where an H100 read 8.0e-6 and 1.2e-5
    over all 640 (2.6e-6 and 4.0e-6 over the 256-deep slices of M = 128,
    where it read 1.5e-6 and 3.1e-6).
    With each 8-deep step in a fresh fragment, as the kernel multiplies,
    the model stays within the f32 tolerances at ``_fwd_split``'s slices.
    The chained design's reading at the old slice depth is recorded, not
    gated."""
    rows = 32
    (_, _, _), (tx, tw, tb) = _inputs(rows, K, N, "float32", seed=5)
    x64 = tx.double() @ tw.double() + tb.double()
    y64 = torch.relu(x64)
    g64 = torch.sum(y64 * y64, dim=1)
    L = kernel._fwd_split(M, K, N)[1]
    old_L = 1024 if M == 640 else L   # the old slices: S = 2 at M = 640

    def errs(ye, ge):
        return (float((ye.double() - y64).abs().max() / y64.abs().max()),
                float((ge.double() - g64).abs().max() / g64.abs().max()))

    fresh = errs(*_split_k_emulation(tx, tw, tb, False, L=L, rz=True))
    chained = errs(*_split_k_emulation(tx, tw, tb, False, L=old_L, rz=True,
                                       fresh=False))
    readings = {"fresh_y": fresh[0], "fresh_g": fresh[1],
                "chained_y": chained[0], "chained_g": chained[1]}
    request.node.user_properties.extend(readings.items())
    print(f"ff_dense {(M, K, N)} under truncating mma: {readings}")
    assert fresh[0] <= TOL["float32"] and fresh[1] <= 5 * TOL["float32"]


@pytest.mark.parametrize("case,match", [
    ("empty_m", "no empty dimension"),
    ("empty_k", "no empty dimension"),
    ("strided_x", "contiguous"),
])
def test_kernel_launch_refuses_what_the_kernel_does_not_take(case, match):
    """The launch's own checks run before the library is built, so they
    hold on any device."""
    x, w, b = torch.ones(4, 8), torch.ones(8, 6), torch.ones(6)
    args = {
        "empty_m": (torch.ones(0, 8), w, b),
        "empty_k": (torch.ones(4, 0), torch.ones(0, 6), b),
        "strided_x": (torch.ones(8, 4).T, w, b),
    }[case]
    with pytest.raises(ValueError, match=match):
        kernel._launch(*args, False)


def test_kernel_launch_refuses_a_block_width_it_is_not_built_for():
    x, w, b = torch.ones(4, 8), torch.ones(8, 6), torch.ones(6)
    with pytest.raises(ValueError, match="block widths"):
        kernel._launch(x, w, b, False, bn=96)
