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
PALLAS_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 1, 32), (2, 128, 4, 4, 128)]
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


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    _, (q, k, v) = _inputs(1, 40, 40, 4, 2, 64)
    before = kernel.LAUNCHES
    for causal, window in MASKS:
        assert torch.equal(
            kernel.flash_attention(q, k, v, causal=causal, window=window),
            kernel.flash_attention_plain(q, k, v, causal=causal,
                                         window=window))
    assert kernel.LAUNCHES == before


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
    before = kernel.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(got, want)
    assert kernel.LAUNCHES == before


@pytest.mark.parametrize("causal,window", MASKS)
def test_chunked_attention_matches_reference_model_path(causal, window):
    (jq, jk, jv), (q, k, v) = _inputs(2, 128, 128, 4, 2, 32, seed=3)
    want = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                   q_chunk=32, k_chunk=64)
    got = attention.chunked_attention(q, k, v, causal=causal, window=window)
    _assert_close(got, want, TOL["float32"])


def test_chunked_attention_offsets_wait_for_their_slice():
    _, (q, k, v) = _inputs(1, 16, 16, 4, 2, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.chunked_attention(q, k, v, q_offset=8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.chunked_attention(q, k, v, k_offset=8)


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
