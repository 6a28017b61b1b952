"""The port's ``ff_dense`` module on the CPU: its plain version and
oracles against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and jnp oracles, the wrapper's CPU
behaviour and operand checks, the ``ops`` dispatch contract, and the
kernel build's lookup and cache key. The CUDA kernel itself is held
against its plain version on the card by ``chip_smoke.py``."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ff_dense import ff_dense as pallas_ff_dense
from repro_torch.kernels import _build, ff_dense as kernel, ops, ref

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
    before = kernel.LAUNCHES
    for norm in (False, True):
        y, g = kernel.ff_dense(x, w, b, norm=norm)
        yp, gp = kernel.ff_dense_plain(x, w, b, norm=norm)
        assert torch.equal(y, yp) and torch.equal(g, gp)
    assert kernel.LAUNCHES == before


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
    before = kernel.LAUNCHES
    y, g = ops.ff_dense(x, w, b, norm=norm)
    fn = ref.ff_dense_norm_ref if norm else ref.ff_dense_ref
    yr, gr = fn(x, w, b)
    assert torch.equal(y, yr) and torch.equal(g, gr)
    assert kernel.LAUNCHES == before


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
