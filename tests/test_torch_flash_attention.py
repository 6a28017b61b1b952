"""The port's ``flash_attention`` module on the CPU: its plain version and
oracle against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and its dense jnp oracle, the
wrapper's CPU behaviour and operand checks, the ``ops`` dispatch
contract, and the model-side attention functions. The CUDA kernel
itself is held against its plain version on the card by
``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as kernel, ops, ref
from repro_torch.models import attention

# tests/test_kernels.py::test_flash_attention*: f32 at 2e-5, bf16 at 5e-2
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# the last two at h2o-danube-3-4b's and recurrentgemma-2b's head widths
PALLAS_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 128, 4, 4, 128),
                 (1, 128, 4, 2, 120), (1, 128, 2, 1, 256)]
MASKS = [(True, None), (True, 64), (False, None)]


def _inputs(B, Sq, Sk, H, KV, hd, dtype="float32", seed=0):
    """The same q, k, v for both packages: numpy from a seed, cast by
    JAX, handed to torch bit for bit."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KV,hd", PALLAS_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_reference_pallas_kernel(B, S, H, KV, hd, causal,
                                               window):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, S, H, KV, hd)
    o = pallas_fa(jq, jk, jv, causal=causal, window=window, bq=64, bk=64)
    _assert_close(kernel.flash_attention_plain(q, k, v, causal=causal,
                                               window=window), o, TOL["float32"])


def test_plain_matches_reference_pallas_kernel_bf16():
    (jq, jk, jv), (q, k, v) = _inputs(1, 128, 128, 4, 2, 64, "bfloat16")
    o = pallas_fa(jq, jk, jv, bq=64, bk=64)
    out = kernel.flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16
    _assert_close(out, o, TOL["bfloat16"])


# ragged S, Sq != Sk, a window wider than S, and a query past the keys'
# end under a window (that row sees no key: both average v over all keys)
ORACLE_CASES = [
    (2, 333, 333, 4, 2, 64, True, 128),
    (1, 70, 70, 6, 3, 32, True, None),
    (1, 48, 80, 4, 4, 64, False, None),
    (1, 80, 48, 4, 2, 64, True, None),
    (1, 100, 100, 2, 1, 128, True, 500),
    (1, 90, 40, 2, 1, 32, False, 16),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", ORACLE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_and_oracle_match_reference_oracle(B, Sq, Sk, H, KV, hd, causal,
                                                 window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, KV, hd, dtype, seed=1)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = kernel.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(got, want, TOL[dtype])
    assert torch.equal(ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window), got)


def test_kernel_head_widths_cover_the_registered_configs():
    """The head width of every registered config the reference has too
    with attention blocks, full and reduced, is one the kernel is built
    for (the port-only MLA config's calls take the chunked route)."""
    from repro_torch.configs import get_config, reference_names
    cfgs = [get_config(n) for n in reference_names()]
    cfgs = [c for c in cfgs + [c.reduced() for c in cfgs]
            if any(k.endswith("attn") for p, _ in c.groups for k in p)]
    assert {c.resolved_head_dim for c in cfgs} == {64, 120, 128, 256}
    assert kernel.KERNEL_HEAD_DIMS == (64, 120, 128, 256)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    _, (q, k, v) = _inputs(1, 40, 40, 4, 2, 64)
    before = kernel.LAUNCHES.total
    for causal, window in MASKS:
        assert torch.equal(
            kernel.flash_attention(q, k, v, causal=causal, window=window),
            kernel.flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
    assert kernel.LAUNCHES.total == before


@pytest.mark.parametrize("case,exc,match", [
    ("rank", ValueError, "expects q"),
    ("kv_mismatch", ValueError, "shape mismatch"),
    ("heads", ValueError, "multiple of KV"),
    ("mixed_dtype", TypeError, "all float32 or all"),
    ("float64", TypeError, "all float32 or all"),
    ("window", TypeError, "window must be an int"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc, match):
    q, k = torch.ones(1, 8, 4, 16), torch.ones(1, 8, 2, 16)
    args = {
        "rank": (q[0], k, k),
        "kv_mismatch": (q, k, torch.ones(1, 9, 2, 16)),
        "heads": (torch.ones(1, 8, 3, 16), k, k),
        "mixed_dtype": (q, k.bfloat16(), k),
        "float64": (q.double(), k.double(), k.double()),
        "window": (q, k, k),
        "meta_device": (q.to("meta"), k.to("meta"), k.to("meta")),
    }[case]
    with pytest.raises(exc, match=match):
        kernel.flash_attention(*args, window=2.5 if case == "window" else None)


def test_ops_unknown_impl_lists_choices():
    _, (q, k, v) = _inputs(1, 16, 16, 4, 2, 64)
    with pytest.raises(ValueError, match="auto | cuda | ref"):
        ops.flash_attention(q, k, v, impl="nope")


def test_ops_cuda_impl_on_a_cpu_tensor_raises():
    _, (q, k, v) = _inputs(1, 16, 16, 4, 2, 64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, k, v, impl="cuda")


@pytest.mark.parametrize("causal,window", MASKS)
def test_ops_auto_on_a_cpu_tensor_is_ref(causal, window):
    _, (q, k, v) = _inputs(1, 96, 96, 4, 2, 64, seed=2)
    before = kernel.LAUNCHES.total
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(got, want)
    assert kernel.LAUNCHES.total == before


@pytest.mark.parametrize("causal,window", MASKS)
def test_chunked_attention_matches_reference_model_path(causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, 128, 4, 2, 32, seed=3)
    want = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                   q_chunk=32, k_chunk=64)
    got = attention.chunked_attention(q, k, v, causal=causal, window=window)
    _assert_close(got, want, TOL["float32"])


def test_chunked_attention_offsets_wait_for_their_slice():
    """Offsets are ported: nonzero ones run the plain masked online
    softmax over global positions (no kernel takes offsets), held to the
    reference's ``chunked_attention`` at 2e-5, causal and windowed, with
    queries behind, level with and ahead of the keys (rows whose every
    key is masked included)."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 64, 96, 4, 2, 64, seed=5)
    for causal, window in [(True, None), (True, 8), (False, 8)]:
        for q_off, k_off in [(8, 0), (40, 12), (0, 8), (3, 3)]:
            want = jattn.chunked_attention(
                jq, jk, jv, causal=causal, window=window, q_offset=q_off,
                k_offset=k_off, q_chunk=16, k_chunk=32)
            got = attention.chunked_attention(
                q, k, v, causal=causal, window=window, q_offset=q_off,
                k_offset=k_off)
            _assert_close(got, want, TOL["float32"])


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 12, 4, 2, 32
    qn = rng.standard_normal((B, H, hd)).astype(np.float32)
    kn = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    vn = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kpos = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1, -1], np.int32)
    want = jattn.decode_attention(jnp.asarray(qn), jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.asarray(kpos), 8,
                                  window=window)
    got = attention.decode_attention(torch.tensor(qn), torch.tensor(kn),
                                     torch.tensor(vn), torch.tensor(kpos), 8,
                                     window=window)
    _assert_close(got, want, TOL["float32"])


# The bf16 kernel's arithmetic (csrc/flash_attention.cu, flash_fwd_tc),
# emulated in torch: Q.K^T from the bf16 operands in f32 with hd^-0.5
# applied after the product; p = exp(s - m) in f32; P.V as two products
# of bf16 operands summed in f32, P split into bf16(p) and bf16(p -
# bf16(p)); l summed from the f32 p. Held at the card's bf16 gates
# (chip_smoke.py): 5e-2 scaled, and elementwise |o - ref| <= 2^-7 |ref| +
# 1e-4 max|ref|, one bf16 rounding apart.
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-4


def _bf16_tensor_core_emulation(q, k, v, causal, window, split=True):
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    qf = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bikgd,bjkd->bkgij", qf, k.float()) * hd ** -0.5
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    vis = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        vis &= qpos >= kpos
    if window is not None:
        vis &= (qpos - kpos) < window
    # masked scores take no weight; a row that sees no key averages v
    s = torch.where(vis, s, torch.full((), -torch.inf))
    s = torch.where(vis.any(1, keepdim=True), s, torch.zeros(()))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p_hi = p.bfloat16().float()
    parts = [p_hi, (p - p_hi).bfloat16().float()] if split else [p_hi]
    o = sum(torch.einsum("bkgij,bjkd->bkgid", pp, v.float()) for pp in parts)
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).bfloat16()


def _bf16_gate_readings(got, want):
    """(scaled error, worst elementwise error over its limit)."""
    got = got.float()
    want = torch.tensor(np.asarray(want.astype(jnp.float32)))
    diff = (got - want).abs()
    lim = BF16_REL * want.abs() + BF16_ABS * want.abs().max()
    return (float(diff.max() / want.abs().max()), float((diff / lim).max()))


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (2, 256, 4, 2, 64, True, None),
    (1, 128, 4, 4, 128, True, 64),
    (1, 128, 8, 2, 64, False, None),
    (1, 128, 4, 2, 120, True, 64),
    (1, 128, 2, 1, 256, True, 32),
])
def test_bf16_tensor_core_arithmetic_meets_gates_against_pallas(
        B, S, H, KV, hd, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(B, S, S, H, KV, hd, "bfloat16", seed=5)
    want = pallas_fa(jq, jk, jv, causal=causal, window=window, bq=64, bk=64)
    got = _bf16_tensor_core_emulation(q, k, v, causal, window)
    scaled, elem = _bf16_gate_readings(got, want)
    assert scaled <= TOL["bfloat16"] and elem <= 1.0, (scaled, elem)


# chip_smoke.py's FA_CHECKS, the qwen2-0.5b prefill cut to B 1, S 512
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (1, 512, 512, 14, 2, 64, True, None),
    (2, 333, 333, 14, 2, 64, True, 128),
    (2, 512, 512, 4, 4, 128, True, None),
    (2, 300, 700, 8, 2, 64, False, None),
    (1, 90, 40, 2, 1, 128, False, 16),
    (2, 300, 700, 8, 2, 120, False, None),
    (1, 333, 333, 4, 1, 256, True, 100),
])
def test_bf16_tensor_core_arithmetic_meets_gates_against_oracle(
        B, Sq, Sk, H, KV, hd, causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, KV, hd, "bfloat16")
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    got = _bf16_tensor_core_emulation(q, k, v, causal, window)
    scaled, elem = _bf16_gate_readings(got, want)
    assert scaled <= TOL["bfloat16"] and elem <= 1.0, (scaled, elem)


def test_bf16_p_alone_misses_the_elementwise_gate():
    """Why the kernel splits P: with P rounded to bf16 alone (SDPA's
    choice) the same arithmetic stays inside the scaled gate but misses
    the elementwise one several-fold (3.7 of the limit with these
    inputs), while the split reads under 1."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 512, 512, 4, 4, 64, "bfloat16")
    want = jref.flash_attention_ref(jq, jk, jv, causal=True)
    scaled, elem = _bf16_gate_readings(
        _bf16_tensor_core_emulation(q, k, v, True, None, split=False), want)
    assert scaled <= TOL["bfloat16"] and elem > 2.0, (scaled, elem)
    _, elem_split = _bf16_gate_readings(
        _bf16_tensor_core_emulation(q, k, v, True, None), want)
    assert elem_split <= 1.0, elem_split
