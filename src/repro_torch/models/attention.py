"""Attention (own copy of ``repro.models.attention``): the full-sequence
path for train and prefill, and the one-token path against a cache for
decode.

The full-sequence path takes one of three routes (``chunked_attention``),
where ``impl`` resolves to the hand-written CUDA kernels:

  * a call that autograd records and ``kernel_grad_route`` takes (causal
    self-attention at offsets 0 on bf16 CUDA tensors of hd 64 or 128:
    the trainers' calls of qwen2, qwen3 and the like) goes to
    ``kernel_attention``, an autograd Function whose forward is the
    kernel saving its residuals and whose backward is the backward
    kernel (``kernels.flash_attention.flash_attention_bwd``);
  * a call that needs no gradient, at offsets 0, goes to
    ``ops.flash_attention``: the kernel, without autograd.

Every other call runs the reference's own route, its pure-JAX chunked
online softmax: q chunks of 512, k chunks of 1024, peak score memory
O(S·chunk), with its §Perf options ``causal_skip`` and ``pv_bf16``
(``AttnOpts``, which act on this route only). That is the CPU, ``impl=
"ref"``, the dry run's fake trace, nonzero offsets, the differentiated
calls the backward kernel does not take (f32, hd 120 and 256, the
encoder's and cross attention), and every call whose values are
narrower than its queries and keys (MLA's dv 128 against 192). The ring
attention body (``models.ring_attention``) shares the online-softmax
merge. Decode
attention is one query row against the cache and stays plain torch, as
the reference's pure-jnp ``decode_attention`` is.

The chunked route records an ``attn.chunked.fwd`` span into
``obs.trace.active()`` and, where that tracer records, the counters
``attn.chunked.calls``, ``attn.chunked.pairs`` /
``attn.chunked.visible_pairs`` and, under autograd, an
``attn.chunked.bwd`` span between two autograd hooks; the kernel route
an ``attn.kernel.fwd`` span, the counter ``attn.kernel.calls`` and an
``attn.kernel.bwd`` span between the same two hooks.
"""
from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import guard, ops, registry
from repro_torch.obs import trace as obs_trace

NEG_INF = -1e30
# the reference's chunk sizes (``chunked_attention``'s defaults)
Q_CHUNK, K_CHUNK = 512, 1024


@dataclasses.dataclass(frozen=True)
class AttnOpts:
    """The reference's §Perf options of its chunked attention, which its
    dry run sets from ``--opts`` (module globals there; an argument the
    entry points carry in ``ctx`` here). They act on the chunked route
    only, never on the kernel, as the reference's act on its pure-JAX
    route and never on its Pallas kernel.

    ``causal_skip``: run only the visible (q chunk, k chunk) pairs (the
    causal triangle and the window band), for causal self-attention at
    offset 0 (the blocks pass it nowhere else). ``pv_bf16``: P and V
    rounded to bf16 for the P·V product, summed in f32 to an f32
    result."""
    causal_skip: bool = False
    pv_bf16: bool = False


def _mask(q_pos, k_pos, causal, window):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def scaled_queries(q, KV):
    """q (B, Sq, H, hd) -> f32 (B, Sq, KV, G, hd) scaled by hd^-0.5."""
    B, Sq, H, hd = q.shape
    return (q.float() * hd ** -0.5).reshape(B, Sq, KV, H // KV, hd)


def block_scores(qf, k, q_pos, k_pos, causal, window):
    """Masked f32 scores (B, KV, G, Sq, Sk) of scaled queries against one
    block of keys, masked by global positions (in place: one buffer)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    return s.masked_fill_(~_mask(q_pos, k_pos, causal, window), NEG_INF)


class _PVBf16(torch.autograd.Function):
    """P (B, KV, G, Sq, Sk) times V (B, Sk, KV, hd), both bf16, summed in
    f32 to an f32 result: the reference's ``einsum(..., preferred_element_
    type=float32)`` on bf16 operands. The products of two bf16 values are
    exact in f32, so the f32 product of the widened operands is that
    function. Autograd keeps the bf16 operands, not f32 copies; the
    cotangents come back rounded to bf16, as JAX's transpose of that
    einsum rounds them to its operands' dtype."""

    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return torch.einsum("bkgqs,bskd->bkgqd", p.float(), v.float())

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        dp = dv = None
        if ctx.needs_input_grad[0]:
            dp = torch.einsum("bkgqd,bskd->bkgqs", g, v.float()).to(p.dtype)
        if ctx.needs_input_grad[1]:
            dv = torch.einsum("bkgqs,bkgqd->bskd", p.float(), g).to(v.dtype)
        return dp, dv


def _pv(p, v, pv_bf16):
    """P @ V, f32 out: on f32 operands, or with ``pv_bf16`` on bf16 ones
    (the reference's ``_pv``). Where no gradient is wanted, P's f32
    values are spent once ``merge_block`` has summed them, so P is
    rounded to bf16 values in place, and the product reads it with no
    f32 copy."""
    if not pv_bf16:
        return torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    if p.requires_grad or v.requires_grad:
        return _PVBf16.apply(p.to(torch.bfloat16), v.to(torch.bfloat16))
    return torch.einsum("bkgqs,bskd->bkgqd", p.copy_(p.to(torch.bfloat16)),
                        v.to(torch.bfloat16).float())


def merge_block(m, l, acc, s, v, *, pv_bf16=False):
    """Online-softmax merge of one block of scores ``s`` (B, KV, G, Sq,
    Sk) and its values ``v`` (B, Sk, KV, hd) into the running max ``m``,
    sum ``l`` and accumulator ``acc``, all f32 (``pv_bf16``: the P·V
    product as ``_pv``'s). ``s`` is overwritten with the block's P, so a
    block holds one score buffer. The running max is differentiated, as
    JAX differentiates the reference's: ``torch.max`` over the keys
    keeps its argmax for the backward, not the scores (``amax`` would
    keep them), so autograd keeps each block's P and nothing else of
    the size of its scores. (The two split a gradient among tied maxima
    differently; a tie needs two equal f32 scores, or a row masked
    whole, whose terms the correction zeroes.)"""
    m_new = torch.maximum(m, torch.max(s, dim=-1).values)
    p = s.sub_(m_new[..., None]).exp_()
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    return m_new, l_new, acc * corr[..., None] + _pv(p, v, pv_bf16)


def softmax_state(qf, dv=None):
    """The online softmax's initial (m, l, acc) for scaled queries qf;
    ``dv``: the values' width (default the queries')."""
    B, Sq, KV, G, hd = qf.shape
    m = torch.full((B, KV, G, Sq), NEG_INF, device=qf.device)
    return m, torch.zeros_like(m), torch.zeros(
        (B, KV, G, Sq, hd if dv is None else dv), device=qf.device)


def finish(l, acc, dtype):
    """acc / l (l clamped at 1e-30) -> (B, Sq, H, hd) in ``dtype``."""
    B, KV, G, Sq, hd = acc.shape
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, hd)


def chunk_size(chunk, S):
    """The reference's chunk-size rule: ``min(chunk, S)``, and the whole
    length where that does not divide S."""
    c = min(chunk, S)
    return S if S % c else c


def visible_q_chunks(j, nq, qc, kc, causal, window):
    """[lo, hi): the q chunks that the reference's ``_triangle_attention``
    pairs with k chunk ``j`` (q chunks of ``qc`` rows, k chunks of
    ``kc``): the pair is skipped where the k chunk lies wholly above the
    causal diagonal (``k_lo > q_hi``) or wholly below the window's band
    (``k_hi <= q_lo - window``). Both rules are monotone in the q chunk,
    so the visible ones are contiguous (possibly none: lo == hi)."""
    k_lo, k_hi = j * kc, j * kc + kc - 1
    seen = [i for i in range(nq)
            if not (causal and k_lo > i * qc + qc - 1)
            and not (window is not None and k_hi <= i * qc - window)]
    if not seen:
        return 0, 0
    assert seen == list(range(seen[0], seen[-1] + 1)), seen
    return seen[0], seen[-1] + 1


def _chunked(q, k, v, *, causal, window, q_offset, k_offset, q_chunk,
             k_chunk, causal_skip, pv_bf16):
    """The reference's chunked route, one k chunk at a time over every q
    chunk that reads it (all of them, or with ``causal_skip`` at offsets
    0 the visible ones). Each q row sees the merges of the reference's
    double scan, k chunks in ascending order, so the values are its. One
    score buffer is alive at a time, (B, KV, G, Sq, k_chunk) f32: O(S·
    chunk), as the reference's, whose (B, KV, G, q_chunk, k_chunk)
    buffer is Sq / q_chunk times smaller, since its scan runs the q
    chunks one at a time where this loop runs them in one op (nk Python
    steps a layer, not nq·nk). Under autograd every visible chunk's P
    is kept, as the reference's scan keeps its residuals. The state of
    the q rows a chunk skips is carried over by concatenation, not
    written in place, so autograd may keep it."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qc, kc = chunk_size(q_chunk, Sq), chunk_size(k_chunk, Sk)
    nq, nk = Sq // qc, Sk // kc
    skip = causal_skip and q_offset == 0 and k_offset == 0
    dev = q.device
    tr = obs_trace.active()
    with tr.span("attn.chunked.fwd", device=dev):
        q_pos = q_offset + torch.arange(Sq, device=dev)
        k_pos = k_offset + torch.arange(Sk, device=dev)
        qf = scaled_queries(q, KV)
        m, l, acc = softmax_state(qf, v.shape[-1])
        for j in range(nk):
            lo, hi = 0, Sq
            if skip:
                lo, hi = (r * qc for r in visible_q_chunks(j, nq, qc, kc,
                                                           causal, window))
                if lo == hi:
                    continue
            ks = slice(j * kc, (j + 1) * kc)
            part = merge_block(m[..., lo:hi], l[..., lo:hi],
                               acc[..., lo:hi, :],
                               block_scores(qf[:, lo:hi], k[:, ks],
                                            q_pos[lo:hi], k_pos[ks], causal,
                                            window),
                               v[:, ks], pv_bf16=pv_bf16)
            if (lo, hi) == (0, Sq):
                m, l, acc = part
            else:
                m = torch.cat([m[..., :lo], part[0], m[..., hi:]], dim=-1)
                l = torch.cat([l[..., :lo], part[1], l[..., hi:]], dim=-1)
                acc = torch.cat([acc[..., :lo, :], part[2],
                                 acc[..., hi:, :]], dim=-2)
        out = finish(l, acc, q.dtype)
    if tr.enabled:
        pairs, seen = chunk_pairs(Sq, Sk, qc, kc, q_offset, k_offset, causal,
                                  window, skip)
        tr.counter("attn.chunked.calls")
        tr.counter("attn.chunked.pairs", B * H * pairs)
        tr.counter("attn.chunked.visible_pairs", B * H * seen)
        if torch.is_grad_enabled() and out.requires_grad:
            _trace_backward(tr, out, (q, k, v), "attn.chunked.bwd")
    return out


@functools.lru_cache(maxsize=64)
def chunk_pairs(Sq, Sk, qc, kc, q_offset, k_offset, causal, window, skip):
    """(pairs, visible) of one (batch row, head) of ``_chunked``: the
    (q, k) pairs its score buffers hold over the k chunks it visits
    (with ``skip``, the visible q chunks of each), and those that the
    causal mask and the window let through."""
    nq, nk = Sq // qc, Sk // kc
    pairs = 0
    for j in range(nk):
        lo, hi = (visible_q_chunks(j, nq, qc, kc, causal, window) if skip
                  else (0, nq))
        pairs += (hi - lo) * qc * kc
    seen = 0
    k_end = k_offset + Sk            # one past the last key position
    for p in range(q_offset, q_offset + Sq):
        hi = min(p + 1, k_end) if causal else k_end
        lo = k_offset if window is None else max(k_offset, p - window + 1)
        seen += max(hi - lo, 0)
    return pairs, seen


def _trace_backward(tr, out, inputs, name):
    """Opens a span ``name`` when ``out``'s gradient arrives and closes
    it when those of ``inputs`` (the ones that need one) are computed;
    its parent is the span the forward's thread has open meanwhile (the
    caller's backward)."""
    needs = [t for t in inputs if t.requires_grad]
    if not needs:
        return
    fwd_thread = threading.get_ident()
    box = []

    def begin(grad):
        box.append(tr.start(name, device=grad.device,
                            parent=tr.current(fwd_thread), push=False))

    def end(grads):
        if box:
            tr.stop(box.pop())

    out.register_hook(begin)
    torch.autograd.graph.register_multi_grad_hook(needs, end)


def kernel_grad_route(device_type, dtypes, q_shape, k_shape, *, causal,
                      q_offset, k_offset):
    """Whether a call that autograd records goes to the kernels, from
    what it shows: q on ``"cuda"``, q, k and v all bf16 (``dtypes``), hd
    one the backward kernel is compiled for
    (``flash_attention.BWD_HEAD_DIMS``), causal self-attention (Sq = Sk)
    at offsets 0, with or without a window."""
    return (device_type == "cuda"
            and all(d == torch.bfloat16 for d in dtypes)
            and q_shape[-1] in fa_kernel.BWD_HEAD_DIMS
            and q_shape[1] == k_shape[1] and causal
            and q_offset == 0 and k_offset == 0)


class _KernelAttention(torch.autograd.Function):
    """Causal self-attention through the kernels: the forward
    ``flash_attention(residuals=True)`` keeps the f32 output and the
    rows' log-sum-exp for the backward, ``flash_attention_bwd``
    (f32 accumulation, bf16 grads). Both are called through the module
    attribute, so that a wrapper put there sees the calls. CPU tensors
    run the plain versions of both."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse, o32 = fa_kernel.flash_attention(q, k, v, causal=True,
                                                  window=window,
                                                  residuals=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        grads = fa_kernel.flash_attention_bwd(q, k, v, o32, lse,
                                              dout.contiguous(),
                                              window=ctx.window)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (
                         None,)


def kernel_attention(q, k, v, *, window=None):
    """Causal self-attention of q (B, S, H, hd) over k, v (B, S, KV, hd)
    that autograd differentiates through the kernels (``_KernelAttention``;
    q, k, v made contiguous). Records an ``attn.kernel.fwd`` span, the
    counter ``attn.kernel.calls`` and, under autograd, an
    ``attn.kernel.bwd`` span."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    tr = obs_trace.active()
    with tr.span("attn.kernel.fwd", device=q.device):
        out = _KernelAttention.apply(q, k, v, window)
    if tr.enabled:
        tr.counter("attn.kernel.calls")
        if torch.is_grad_enabled() and out.requires_grad:
            _trace_backward(tr, out, (q, k, v), "attn.kernel.bwd")
    return out


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      k_offset=0, q_chunk=Q_CHUNK, k_chunk=K_CHUNK,
                      causal_skip=False, pv_bf16=False, impl="auto"):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv).
    Returns (B, Sq, H, dv).

    Query i sits at position ``q_offset + i`` and key j at ``k_offset +
    j``. ``impl`` names a ``registry.flash_attention`` entry (``"auto"``:
    the one for q's device). Where it names the CUDA kernel (``"cuda"``),
    a call that autograd records goes to ``kernel_attention`` if
    ``kernel_grad_route`` takes it, and to the chunked route if not. Any
    other call at offsets 0 whose impl is not the plain ``"ref"`` goes to
    ``ops.flash_attention``, that impl. The options reach neither, as the
    reference's options never reach its Pallas kernel. Every other call
    runs the reference's chunked online
    softmax (``_chunked``) with ``q_chunk``, ``k_chunk``, ``causal_skip``
    (offsets 0 only, as in the reference) and ``pv_bf16``, and so does
    every call whose value width differs from the query's (MLA's), which
    no kernel takes."""
    name = registry.flash_attention.lookup(impl, q.device.type).name
    if v.shape[-1] != q.shape[-1]:
        name = "ref"
    if name == "cuda" and guard.records_grad(q, k, v):
        if kernel_grad_route(
                q.device.type, (q.dtype, k.dtype, v.dtype), q.shape, k.shape,
                causal=causal, q_offset=q_offset, k_offset=k_offset):
            return kernel_attention(q, k, v, window=window)
    elif name != "ref" and q_offset == 0 and k_offset == 0:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl=impl)
    return _chunked(q, k, v, causal=causal, window=window,
                    q_offset=q_offset, k_offset=k_offset, q_chunk=q_chunk,
                    k_chunk=k_chunk, causal_skip=causal_skip,
                    pv_bf16=pv_bf16)


def decode_attention(q, k_cache, v_cache, k_pos, cur_pos, *, window=None):
    """One-token attention against a cache.

    q: (B, H, hd); k_cache/v_cache: (B, S, KV, hd); k_pos: (S,) integer
    positions held in each cache slot (-1 = empty); cur_pos: the query
    token's position.
    """
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = (k_pos >= 0) & (k_pos <= cur_pos)
    if window is not None:
        valid &= (cur_pos - k_pos) < window
    s = torch.where(valid[None, None, None], s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_part(q, k_cache, v_cache, k_pos, cur_pos, *,
                          window=None):
    """``decode_attention`` over a part of the keys (a rank's slots of a
    cache split over a mesh axis): each head's (max score, sum of
    ``exp(score - max)``, those weights times the values), (B, H),
    (B, H), (B, H, hd) f32, for ``sharding.softmax_combine``. Masked
    slots score ``NEG_INF``: a part with none valid weighs nothing once
    combined with one that has."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    qf = q.reshape(B, KV, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    valid = (k_pos >= 0) & (k_pos <= cur_pos)
    if window is not None:
        valid &= (cur_pos - k_pos) < window
    s = torch.where(valid[None, None, None], s,
                    torch.full((), NEG_INF, device=s.device))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return m.reshape(B, H), p.sum(-1).reshape(B, H), o.reshape(B, H, hd)
