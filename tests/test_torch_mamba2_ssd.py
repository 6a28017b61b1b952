"""The port's ``mamba2_ssd`` module on the CPU: its plain version against
the reference's Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and its sequential jnp oracle, the port's ``ssd_chunked``
against the reference model's, the wrapper's CPU behaviour and operand
checks, and the ``ops`` dispatch contract. The CUDA kernel itself is held
against its plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_ssd as pallas_ssd
from repro.models import ssm as jssm
from repro_torch.kernels import mamba2_ssd as kernel, ops, ref
from repro_torch.models import ssm

# tests/test_kernels.py::test_mamba2_ssd and
# test_ssd_kernel_matches_model_path: 2e-4
TOL = 2e-4


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _inputs(B, S, H, hd, N, seed=0):
    """xbar, dA (= -softplus(normal), as the reference's tests draw it),
    b, c as numpy f32, and the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    xbar = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dA = (-_softplus(rng.standard_normal((B, S, H)))).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    arrs = (xbar, dA, b, c)
    return [jnp.asarray(a) for a in arrs], [torch.tensor(a) for a in arrs]


def _assert_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("B,S,H,hd,N,chunk", [(2, 128, 4, 32, 16, 32),
                                              (1, 256, 8, 16, 64, 64),
                                              (2, 64, 2, 64, 128, 64)])
def test_plain_matches_reference_pallas_kernel(B, S, H, hd, N, chunk):
    jx, tx = _inputs(B, S, H, hd, N)
    y, hT = pallas_ssd(*jx, chunk=chunk)
    yp, hp = kernel.mamba2_ssd_plain(*tx, chunk=chunk)
    assert yp.dtype == hp.dtype == torch.float32
    assert yp.shape == (B, S, H, hd) and hp.shape == (B, H, hd, N)
    _assert_close(yp, y)
    _assert_close(hp, hT)


# chunks that divide S, that do not (padded with inert rows), and one
# longer than S (L = S)
@pytest.mark.parametrize("B,S,H,hd,N,chunk", [(2, 96, 4, 32, 16, 32),
                                              (1, 100, 3, 16, 32, 32),
                                              (2, 77, 2, 32, 16, 64),
                                              (1, 40, 2, 16, 8, 128)])
def test_plain_and_oracle_match_reference_sequential_oracle(B, S, H, hd, N,
                                                            chunk):
    jx, tx = _inputs(B, S, H, hd, N, seed=1)
    y, hT = jref.mamba2_ssd_ref(*jx)
    yp, hp = kernel.mamba2_ssd_plain(*tx, chunk=chunk)
    _assert_close(yp, y)
    _assert_close(hp, hT)
    yr, hr = ref.mamba2_ssd_ref(*tx, chunk=chunk)
    assert torch.equal(yr, yp) and torch.equal(hr, hp)


@pytest.mark.parametrize("S,chunk", [(128, 32), (100, 32), (20, 32)])
def test_ssd_chunked_matches_reference_model_path(S, chunk):
    rng = np.random.default_rng(2)
    B, H, hd, N = 2, 4, 32, 16
    xh = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    dt = _softplus(rng.standard_normal((B, S, H))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.2)).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    arrs = (xh, dt, A, b, c)
    y, hT = jssm.ssd_chunked(*[jnp.asarray(a) for a in arrs], chunk)
    yp, hp = ssm.ssd_chunked(*[torch.tensor(a) for a in arrs], chunk)
    _assert_close(yp, y)
    _assert_close(hp, hT)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    _, tx = _inputs(1, 70, 2, 16, 16)
    before = kernel.LAUNCHES
    for chunk in (32, 64):
        y, hT = kernel.mamba2_ssd(*tx, chunk=chunk)
        yp, hp = kernel.mamba2_ssd_plain(*tx, chunk=chunk)
        assert torch.equal(y, yp) and torch.equal(hT, hp)
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize("case,exc,match", [
    ("rank", ValueError, "expects xbar"),
    ("dA_shape", ValueError, "shape mismatch"),
    ("c_shape", ValueError, "shape mismatch"),
    ("bf16", TypeError, "float32 xbar"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    x, dA, b = torch.ones(1, 8, 2, 16), torch.ones(1, 8, 2), torch.ones(1, 8, 4)
    args = {
        "rank": (x[0], dA, b, b),
        "dA_shape": (x, torch.ones(1, 8, 3), b, b),
        "c_shape": (x, dA, b, torch.ones(1, 8, 5)),
        "bf16": (x, dA, b.bfloat16(), b),
        "meta_device": tuple(t.to("meta") for t in (x, dA, b, b)),
    }[case]
    with pytest.raises(exc, match=match):
        kernel.mamba2_ssd(*args, chunk=64)


def test_ops_unknown_impl_lists_choices():
    _, tx = _inputs(1, 16, 2, 16, 8)
    with pytest.raises(ValueError, match="auto | cuda | ref"):
        ops.mamba2_ssd(*tx, chunk=16, impl="nope")


def test_ops_cuda_impl_on_a_cpu_tensor_raises():
    _, tx = _inputs(1, 16, 2, 16, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.mamba2_ssd(*tx, chunk=16, impl="cuda")


@pytest.mark.parametrize("chunk", [32, 48])
def test_ops_auto_on_a_cpu_tensor_is_ref(chunk):
    _, tx = _inputs(2, 96, 3, 16, 16, seed=3)
    before = kernel.LAUNCHES
    y, hT = ops.mamba2_ssd(*tx, chunk=chunk)
    yr, hr = ref.mamba2_ssd_ref(*tx, chunk=chunk)
    assert torch.equal(y, yr) and torch.equal(hT, hr)
    assert kernel.LAUNCHES == before
