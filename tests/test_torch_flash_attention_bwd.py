"""The backward of attention through the kernels, on the CPU: the plain
backward (``flash_attention_bwd_plain``, from the forward's f32 output and
log-sum-exp, the kernel's arithmetic) against ``jax.grad`` of the
reference's chunked attention (hd 64 and 128, causal with and without a
window, GQA 7/1 and 4/2, a ragged S of 96 and S 1024); the forward's
residuals against the plain forward's; the autograd Function
(``models.attention.kernel_attention``, which on CPU tensors runs both
plain versions) against the chunked route's autograd; the route rule as
a pure predicate over what a call shows, and ``chunked_attention``'s
choice by the impl the registry resolves; the trainers' block step through
the kernel route (the rule forced on CPU tensors) against the chunked
route; the spans and counters of both routes, and the two benchmark
readers over them. The kernels themselves run on the card
(``chip_smoke.py`` phase 37).
"""
import dataclasses
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.core import pff_lm
from repro_torch.core import train as train_lib
from repro_torch.kernels import flash_attention as fa, ref
from repro_torch.models import attention, blocks
from repro_torch.obs import trace as obs_trace

# gradients, scaled by max |reference| (the chunked route's own tolerance
# against jax.grad, tests/test_torch_chunked_attention.py)
SCALED_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]

# (B, S, H, KV, hd, window)
CASES = {
    "hd64_gqa7_s96": (2, 96, 7, 1, 64, None),
    "hd64_gqa4_2_s96_window": (2, 96, 4, 2, 64, 40),
    "hd128_gqa4_2_s96": (1, 96, 4, 2, 128, None),
    "hd128_gqa7_s96_window": (1, 96, 7, 1, 128, 33),
    "hd64_gqa7_s1024": (1, 1024, 7, 1, 64, None),
    "hd128_gqa4_2_s1024_window": (1, 1024, 4, 2, 128, 300),
}


def _err(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(name):
    B, S, H, KV, hd, window = CASES[name]
    q, k, v, ct = _inputs(B, S, H, KV, hd, seed=len(name))

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out * ct)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt, dt = (torch.tensor(a) for a in (q, k, v, ct))
    out, lse, o32 = fa.flash_attention_plain(qt, kt, vt, window=window,
                                             residuals=True)
    got = fa.flash_attention_bwd_plain(qt, kt, vt, o32, lse, dt,
                                       window=window)
    for g, w, n in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape, n
        assert _err(g.numpy(), w) <= SCALED_TOL, n


@pytest.mark.parametrize("name", ["hd64_gqa4_2_s96_window",
                                  "hd128_gqa7_s96_window"])
def test_forward_residuals(name):
    """lse is the rows' log-sum-exp of the scaled, masked scores; the f32
    output is the output before its rounding; the output is unchanged."""
    B, S, H, KV, hd, window = CASES[name]
    q, k, v, _ = (torch.tensor(a) for a in _inputs(B, S, H, KV, hd, 1))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    out, lse, o32 = fa.flash_attention(qb, kb, vb, window=window,
                                       residuals=True)
    assert torch.equal(out, fa.flash_attention(qb, kb, vb, window=window))
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert o32.shape == q.shape and o32.dtype == torch.float32
    assert torch.equal(out, o32.to(torch.bfloat16))
    G = H // KV
    s = torch.einsum("bihd,bjhd->bhij", qb.float(),
                     kb.float().repeat_interleave(G, dim=2)) * hd ** -0.5
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    seen = (j <= i) & ((i - j) < window)
    want = torch.logsumexp(s.masked_fill(~seen, -torch.inf), dim=-1)
    assert _err(lse.numpy(), want.numpy()) <= 1e-6


def _route_grads(fn, arrays, window):
    """``fn``'s output and the grads of its inputs; the inputs are
    computed from leaves, as a model's q, k and v are (the backward
    spans' hooks sit on them)."""
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    out = fn(*(t * 1.0 for t in leaves), window=window)
    return out, torch.autograd.grad(out, leaves, torch.tensor(arrays[3]))


@pytest.mark.parametrize("name", ["hd64_gqa7_s96", "hd128_gqa4_2_s96",
                                  "hd64_gqa4_2_s96_window"])
def test_function_matches_the_chunked_route(name):
    """On CPU tensors the Function runs the plain forward and backward:
    its output and grads are the chunked route's under autograd."""
    B, S, H, KV, hd, window = CASES[name]
    arrays = _inputs(B, S, H, KV, hd, seed=3)
    out, got = _route_grads(attention.kernel_attention, arrays, window)
    want_out, want = _route_grads(
        lambda q, k, v, window: attention.chunked_attention(
            q, k, v, window=window, impl="ref"), arrays, window)
    assert _err(out.detach().numpy(), want_out.detach().numpy()) <= 2e-5
    for g, w, n in zip(got, want, "qkv"):
        assert _err(g.numpy(), w.numpy()) <= SCALED_TOL, n


def _route(cfg_name="qwen2-0.5b", *, device="cuda", dtype=torch.bfloat16,
           B=8, S=4096, hd=None, causal=True, Sk=None, q_offset=0,
           k_offset=0):
    cfg = get_config(cfg_name)
    hd = hd or cfg.resolved_head_dim
    q_shape = (B, S, cfg.n_heads, hd)
    k_shape = (B, S if Sk is None else Sk, cfg.n_kv, hd)
    return attention.kernel_grad_route(
        device, (dtype, dtype, dtype), q_shape, k_shape, causal=causal,
        q_offset=q_offset, k_offset=k_offset)


def test_route_rule():
    """qwen2's and qwen3's training calls take the kernels; f32, hd 120
    and 256, non-causal, Sq != Sk, nonzero offsets and CPU calls keep the
    chunked route."""
    assert _route("qwen2-0.5b")
    assert _route("qwen2-0.5b", B=64, S=512)
    assert _route("qwen3-8b", B=4, S=2048)
    assert _route("tinyllama-1.1b", S=97)
    assert not _route(dtype=torch.float32)
    assert not _route("h2o-danube-3-4b")
    assert not _route("recurrentgemma-2b")
    assert not _route(hd=256)
    assert not _route(causal=False)
    assert not _route(Sk=1024)
    assert not _route(q_offset=16)
    assert not _route(k_offset=16)
    assert not _route(device="cpu")
    assert not attention.kernel_grad_route(
        "cuda", (torch.bfloat16, torch.float32, torch.bfloat16),
        (8, 64, 14, 64), (8, 64, 2, 64), causal=True, q_offset=0,
        k_offset=0)


def _tiny_qwen2():
    """qwen2-0.5b cut to 256 wide (4 / 2 heads of 64), in its own bf16."""
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="bfloat16")


@pytest.fixture
def kernel_rule_on_cpu(monkeypatch):
    """The kernels' route taken on CPU tensors (its Function runs the
    plain versions there): ``"auto"`` resolves to a stand-in for the CUDA
    entry, which runs the plain forward and records its calls
    (``kernel_rule_on_cpu.calls``), and the rule ignores the device."""
    rule = attention.kernel_grad_route
    lookup = attention.registry.flash_attention.lookup
    calls = []

    def fn(q, k, v, *, causal, window):
        calls.append(q.shape)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    kimpl = types.SimpleNamespace(name="cuda", fn=fn)
    monkeypatch.setattr(attention.registry.flash_attention, "lookup",
                        lambda impl, platform: (kimpl if impl == "auto"
                                                else lookup(impl, platform)))
    monkeypatch.setattr(attention, "kernel_grad_route",
                        lambda device, *a, **kw: rule("cuda", *a, **kw))
    return types.SimpleNamespace(calls=calls)


def _routed(impl, *, grad, window=None):
    """(kernel route calls, chunked route calls) of one
    ``chunked_attention`` call at qwen2's head shape, 96 rows in bf16,
    its operands requiring grad or not."""
    arrays = _inputs(1, 96, 4, 2, 64, seed=4)
    q, k, v = (torch.tensor(a).bfloat16().requires_grad_(grad)
               for a in arrays[:3])
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        attention.chunked_attention(q, k, v, window=window, impl=impl)
    return (tr.counters.get("attn.kernel.calls", 0),
            tr.counters.get("attn.chunked.calls", 0))


def test_chunked_attention_routes_by_the_resolved_impl(kernel_rule_on_cpu):
    """A recorded call whose impl is the CUDA kernel takes the kernels'
    Function; the same call without grad takes that impl's no-grad
    forward; a recorded call naming another registered impl runs that
    impl, and ``"ref"`` the chunked route, grad or not."""
    calls = kernel_rule_on_cpu.calls
    assert _routed("auto", grad=True) == (1, 0)
    assert calls == []
    with torch.no_grad():
        assert _routed("auto", grad=True) == (0, 0)
    assert _routed("auto", grad=False, window=40) == (0, 0)
    assert len(calls) == 2
    seen = []

    def probe(q, k, v, *, causal, window):
        seen.append(torch.is_grad_enabled())
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
    attention.registry.flash_attention.register("probe", probe)
    try:
        assert _routed("probe", grad=True) == (0, 0)
    finally:
        attention.registry.flash_attention.unregister("probe")
    assert seen == [True] and len(calls) == 2
    for grad in (True, False):
        assert _routed("ref", grad=grad) == (0, 1)


def _block_grads(cfg, ctx, seed=0):
    params = pff_lm.init_params(cfg, seed, "cpu")
    unit = pff_lm.block_units(params, 1)[0]
    pattern = cfg.groups[0][0]
    x = torch.randn(4, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(5)).bfloat16()
    tp = train_lib.trainable(unit)
    with torch.enable_grad():
        h = x
        total = 0.0
        for kind, bp in zip(pattern, tp):
            y, _ = blocks.block_apply(bp, cfg, kind, h, ctx)
            total = total + (y - h).float().pow(2).mean()
            h = y
        return float(total.detach()), train_lib.grads_of(total, tp)


def test_block_step_takes_the_kernel_route(kernel_rule_on_cpu):
    """The trainers' ctx (``train.REF``) sends the block's attention to
    the kernels where the rule takes it, and ``attn_impl="ref"`` keeps it
    on the chunked route; both give the same loss and grads."""
    cfg = _tiny_qwen2()
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        loss_k, got = _block_grads(cfg, train_lib.REF)
    assert tr.counters.get("attn.kernel.calls") == 1
    assert "attn.chunked.calls" not in tr.counters
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        loss_c, want = _block_grads(cfg, {**train_lib.REF,
                                          "attn_impl": "ref"})
    assert tr.counters.get("attn.chunked.calls") == 1
    assert "attn.kernel.calls" not in tr.counters
    assert abs(loss_k - loss_c) <= 1e-2 * abs(loss_c)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert _err(g.float().numpy(), w.float().numpy()) <= 5e-2


def test_pod_ctx_keeps_the_plain_route():
    from repro_torch.core import pff_pod

    assert pff_pod._CTX["attn_impl"] == "ref"
    assert train_lib.REF["impl"] == "ref"      # the SSD has no backward


def _spans(tr):
    return [s.name for s in tr.spans]


def test_spans_and_counters():
    """The chunked route counts its calls; the kernel route records its
    forward span, its calls and, once the backward ran, its backward
    span between the two hooks."""
    arrays = _inputs(1, 96, 4, 2, 64, seed=9)
    tr = obs_trace.Tracer()
    with obs_trace.use(tr):
        _route_grads(lambda q, k, v, window: attention.chunked_attention(
            q, k, v, window=window), arrays, None)
        _route_grads(attention.kernel_attention, arrays, None)
        _route_grads(attention.kernel_attention, arrays, 40)
        with torch.no_grad():
            attention.kernel_attention(*(torch.tensor(a)
                                         for a in arrays[:3]))
    assert tr.counters["attn.chunked.calls"] == 1
    assert tr.counters["attn.kernel.calls"] == 3
    names = _spans(tr)
    assert names.count("attn.chunked.fwd") == 1
    assert names.count("attn.chunked.bwd") == 1
    assert names.count("attn.kernel.fwd") == 3
    assert names.count("attn.kernel.bwd") == 2


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", ROOT / "portbench" / "metrics"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, device_s):
    return {"name": name, "device_s": device_s}


@pytest.mark.parametrize("spans, counters, share, route", [
    ([_span("attn.chunked.fwd", 1.0), _span("attn.chunked.bwd", 3.0),
      _span("lm.prefix", 2.0)],
     {"attn.chunked.calls": 24}, 40.0, 0.0),
    ([_span("attn.kernel.fwd", 0.5), _span("attn.kernel.bwd", 1.5),
      _span("attn.kernel.bwd", None)],
     {"attn.kernel.calls": 24}, 20.0, 100.0),
    ([_span("attn.kernel.fwd", 0.5), _span("attn.chunked.fwd", 0.5)],
     {"attn.kernel.calls": 3, "attn.chunked.calls": 1}, 10.0, 75.0),
    ([_span("lm.prefix", 2.0)], {}, None, None),
])
def test_readers(spans, counters, share, route):
    run = types.SimpleNamespace(program={"spans": spans,
                                         "counters": counters},
                                window_s=10.0, trace={})
    got = _reader("attn_train_pct.lm")(run)
    assert got == pytest.approx(share) if share is not None else got is None
    got = _reader("attn_kernel_route_pct.lm")(run)
    assert got == pytest.approx(route) if route is not None else got is None
