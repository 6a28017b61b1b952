"""The port's ``mamba2_ssd`` module on the CPU: its plain version against
the reference's Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and its sequential jnp oracle, the port's ``ssd_chunked``
against the reference model's, the wrapper's CPU behaviour and operand
checks, the ``ops`` dispatch contract, and the kernel's chunk-parallel
3xTF32 arithmetic emulated in its own order against the Pallas kernel
and the oracle. The CUDA kernel itself is held against its plain version
on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import mamba2_ssd as pallas_ssd
from repro.models import ssm as jssm
from repro_torch.kernels import mamba2_ssd as kernel, ops, ref
from repro_torch.models import ssm
from tf32_emulation import mm_tf32

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
    before = kernel.LAUNCHES.total
    for chunk in (32, 64):
        y, hT = kernel.mamba2_ssd(*tx, chunk=chunk)
        yp, hp = kernel.mamba2_ssd_plain(*tx, chunk=chunk)
        assert torch.equal(y, yp) and torch.equal(hT, hp)
    assert kernel.LAUNCHES.total == before


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
    before = kernel.LAUNCHES.total
    y, hT = ops.mamba2_ssd(*tx, chunk=chunk)
    yr, hr = ref.mamba2_ssd_ref(*tx, chunk=chunk)
    assert torch.equal(y, yr) and torch.equal(hT, hr)
    assert kernel.LAUNCHES.total == before


def _chunk_cumsum(dA):
    """cums over axis 1 of (B, L, H) in csrc/mamba2_ssd.cu's order
    (chunk_cumsum): per-lane f32 runs of L / 32 steps, then a
    Hillis-Steele scan of the 32 lane totals, each run shifted by the
    totals of the lanes before it."""
    B, L, H = dA.shape
    per = L // 32
    steps = dA.reshape(B, 32, per, H)
    runs, run = [], torch.zeros(B, 32, H)
    for e in range(per):
        run = run + steps[:, :, e]
        runs.append(run)
    runs = torch.stack(runs, dim=2)
    incl = run
    for off in (1, 2, 4, 8, 16):
        incl = incl + F.pad(incl, (0, 0, off, 0))[:, :32]
    excl = F.pad(incl, (0, 0, 1, 0))[:, :32]
    return (runs + excl[:, :, None]).reshape(B, L, H)


def _ssd_chunk_parallel_emulation(xbar, dA, b, c, chunk, products=3):
    """csrc/mamba2_ssd.cu's arithmetic, launch by launch, every product
    as 3xTF32 in the kernel's 8-deep steps (``products=3``): (1) scores
    c_i . b_j; (2) each chunk's own state (exp(cums_L - cums_j) xbar_j)^T
    . b_j; (3) the state pass h <- h exp(cums_L) + S_c in chunk order,
    keeping the state entering each chunk; (4) y = W . xbar +
    exp(cums_i) (c_i . h_in), W = cb exp(cums_i - cums_j) for j <= i.
    A ragged S is padded with zero rows, which the kernel reads."""
    B, S, H, hd = xbar.shape
    N = b.shape[-1]
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    xb = F.pad(xbar, (0, 0, 0, 0, 0, pad)).reshape(B, nc, L, H, hd)
    bc = F.pad(b, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cc = F.pad(c, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cums = _chunk_cumsum(F.pad(dA, (0, 0, 0, pad)).reshape(B * nc, L, H))
    cums = cums.reshape(B, nc, L, H).permute(0, 1, 3, 2)       # (B,nc,H,L)
    cb = mm_tf32(cc, bc.transpose(-1, -2), products)            # (B,nc,i,j)
    last = cums[..., -1]                                        # (B,nc,H)
    xs = xb.permute(0, 1, 3, 4, 2) * torch.exp(last[..., None] - cums)[
        :, :, :, None, :]                                       # (B,nc,H,d,j)
    states = mm_tf32(xs, bc[:, :, None], products)              # (B,nc,H,d,n)
    h, h_in = torch.zeros(B, H, hd, N), []
    for ci in range(nc):
        h_in.append(h)
        h = h * torch.exp(last[:, ci])[..., None, None] + states[:, ci]
    h_in = torch.stack(h_in, dim=1)                             # (B,nc,H,d,n)
    seg = cums[..., :, None] - cums[..., None, :]               # (B,nc,H,i,j)
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool))
    w = torch.where(mask, cb[:, :, None] * torch.exp(seg), torch.zeros(()))
    intra = mm_tf32(w, xb.permute(0, 1, 3, 2, 4), products)     # (B,nc,H,i,d)
    inter = mm_tf32(cc[:, :, None], h_in.transpose(-1, -2), products)
    y = intra + inter * torch.exp(cums)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * L, H, hd)[:, :S]
    return y, h


def _mild_inputs(B, S, H, hd, N, seed):
    """As ``_inputs``, with mamba2's mild decay (dt in [0.001, 0.1]
    against A = -1), so the state carries across chunks."""
    jx, tx = _inputs(B, S, H, hd, N, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dA = (-np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (B, S, H)))
          ).astype(np.float32)
    jx[1], tx[1] = jnp.asarray(dA), torch.tensor(dA)
    return jx, tx


def _assert_scaled(got, want):
    """max|got - want| / max|want| <= TOL: the SSD gate of chip_smoke.py
    (2e-4 scaled). At N 128 with strong decay single outputs cancel to
    near zero, where any f32 order (the Pallas kernel's included) can
    leave the elementwise 2e-4 band around a float64 truth."""
    want = torch.tensor(np.asarray(want))
    assert float((got - want).abs().max() / want.abs().max()) <= TOL


def _record(request, name, got, want, products):
    """Scaled errors of 3xTF32 and of one TF32 product, printed and kept
    in the test's user properties (not gated)."""
    want = torch.tensor(np.asarray(want))
    readings = {f"{name}_err_{n}xtf32": float((g - want).abs().max()
                                             / want.abs().max())
                for n, g in ((3, got), (1, products))}
    request.node.user_properties.extend(readings.items())
    print(readings)


# the kernel's sizes (hd 64, N 128, chunk 128 / 256), cut in B, S and H
@pytest.mark.parametrize("B,S,H,chunk,decay", [(2, 256, 3, 128, "strong"),
                                               (1, 512, 2, 256, "mild"),
                                               (2, 384, 2, 128, "mild")])
def test_chunk_parallel_3xtf32_arithmetic_matches_reference_pallas_kernel(
        B, S, H, chunk, decay, request):
    """The kernel's arithmetic against the Pallas kernel at the
    reference's tolerance (2e-4 scaled). With one TF32 product (recorded,
    not gated) the CPU reads 4e-4 to 5.2e-4 scaled y error at these and
    the oracle test's inputs, above the gate; 3xTF32 reads 4.2e-7 to
    5.7e-6 (the most under strong decay, against the Pallas kernel's own
    f32 rounding)."""
    make = _mild_inputs if decay == "mild" else (
        lambda *a, seed: _inputs(*a, seed=seed))
    jx, tx = make(B, S, H, 64, 128, seed=5)
    y, hT = pallas_ssd(*jx, chunk=chunk)
    ye, he = _ssd_chunk_parallel_emulation(*tx, chunk)
    _assert_scaled(ye, y)
    _assert_scaled(he, hT)
    y1, _ = _ssd_chunk_parallel_emulation(*tx, chunk, products=1)
    _record(request, "y", ye, y, y1)


# ragged S (a zero-padded last chunk), against the sequential oracle
@pytest.mark.parametrize("B,S,H,chunk", [(2, 300, 2, 128), (1, 200, 3, 256)])
def test_chunk_parallel_3xtf32_arithmetic_matches_sequential_oracle(
        B, S, H, chunk, request):
    jx, tx = _mild_inputs(B, S, H, 64, 128, seed=6)
    y, hT = jref.mamba2_ssd_ref(*jx)
    ye, he = _ssd_chunk_parallel_emulation(*tx, chunk)
    _assert_scaled(ye, y)
    _assert_scaled(he, hT)
    y1, _ = _ssd_chunk_parallel_emulation(*tx, chunk, products=1)
    _record(request, "y", ye, y, y1)


def test_chunk_cumsum_order_matches_a_sequential_sum():
    dA = -torch.rand(2, 256, 3, generator=torch.Generator().manual_seed(7))
    want = torch.cumsum(dA.double(), dim=1)
    got = _chunk_cumsum(dA)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("case,match", [
    ("chunk_64", "chunk in"),
    ("hd_32", r"hd in \(64,\)"),
    ("n_16", r"N in \(128,\)"),
    ("strided_b", "contiguous"),
])
def test_kernel_launch_refuses_what_the_kernel_does_not_take(case, match):
    """The launch's own checks run before the library is built, so they
    hold on any device: the kernel is compiled for (chunk, hd, N) in
    ``KERNEL_CONFIGS`` only, each combination as a whole (hd 32 at chunk
    128, or N 16 at chunk 128, is refused though both appear at chunk
    32)."""
    x, dA = torch.ones(1, 8, 2, 64), torch.ones(1, 8, 2)
    b = torch.ones(1, 8, 128)
    args, chunk = {
        "chunk_64": ((x, dA, b, b), 64),
        "hd_32": ((torch.ones(1, 8, 2, 32), dA, b, b), 128),
        "n_16": ((x, dA, torch.ones(1, 8, 16), torch.ones(1, 8, 16)), 128),
        "strided_b": ((x, dA, torch.ones(1, 128, 8).transpose(1, 2), b), 128),
    }[case]
    with pytest.raises(ValueError, match=match):
        kernel._launch(*args, chunk)


# the reduced mamba2-780m config's sizes (chunk 32, hd 32, N 16), ragged S
@pytest.mark.parametrize("B,S,H", [(2, 200, 16), (1, 45, 3), (1, 96, 4)])
def test_chunk_parallel_3xtf32_arithmetic_at_the_reduced_sizes(B, S, H,
                                                               request):
    """The kernel's arithmetic at the (32, 32, 16) instantiation, against
    the sequential oracle and, where S is a whole number of chunks (the
    Pallas kernel takes no other), the Pallas kernel: the same algebra at
    32-row tiles, which the kernel takes for a chunk of 32."""
    jx, tx = _mild_inputs(B, S, H, 32, 16, seed=8)
    ye, he = _ssd_chunk_parallel_emulation(*tx, 32)
    wants = [jref.mamba2_ssd_ref(*jx)]
    if S % 32 == 0:
        wants.append(pallas_ssd(*jx, chunk=32))
    for y, hT in wants:
        _assert_scaled(ye, y)
        _assert_scaled(he, hT)
    y1, _ = _ssd_chunk_parallel_emulation(*tx, 32, products=1)
    _record(request, "y", ye, jref.mamba2_ssd_ref(*jx)[0], y1)


@pytest.mark.parametrize("chunk,hd,N", kernel.KERNEL_CONFIGS)
def test_kernel_takes_each_compiled_combination(chunk, hd, N):
    """Every compiled (chunk, hd, N) passes the launch's size check, and
    the reduced mamba2-780m config is one of them."""
    kernel._check_compiled(chunk, hd, N)
    from repro_torch.configs import get_config
    ssm_cfg = get_config("mamba2-780m").reduced().ssm
    assert (ssm_cfg.chunk, ssm_cfg.head_dim, ssm_cfg.state_dim) in \
        kernel.KERNEL_CONFIGS
