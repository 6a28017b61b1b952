"""Attention (own copy of ``repro.models.attention``): the full-sequence
path for prefill, and the one-token path against a cache for decode.

The reference runs its full-sequence path as a pure-JAX chunked online
softmax and validates its Pallas kernel against it; the port routes the
same function through the kernel op itself (``ops.flash_attention``:
the hand-written CUDA kernel on the card, the plain version on the
CPU), except with position offsets, which neither kernel takes: those
run the plain online softmax here, whose merge the ring attention body
(``models.ring_attention``) shares. Decode attention is one query row
against the cache and stays plain torch, as the reference's pure-jnp
``decode_attention`` is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


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
    block of keys, masked by global positions."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    msk = _mask(q_pos, k_pos, causal, window)
    return torch.where(msk, s, torch.full((), NEG_INF, device=s.device))


def merge_block(m, l, acc, s, v):
    """Online-softmax merge of one block of scores ``s`` (B, KV, G, Sq,
    Sk) and its values ``v`` (B, Sk, KV, hd) into the running max ``m``,
    sum ``l`` and accumulator ``acc``, all f32."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def softmax_state(qf):
    """The online softmax's initial (m, l, acc) for scaled queries qf."""
    B, Sq, KV, G, hd = qf.shape
    m = torch.full((B, KV, G, Sq), NEG_INF, device=qf.device)
    return m, torch.zeros_like(m), torch.zeros((B, KV, G, Sq, hd),
                                               device=qf.device)


def finish(l, acc, dtype):
    """acc / l (l clamped at 1e-30) -> (B, Sq, H, hd) in ``dtype``."""
    B, KV, G, Sq, hd = acc.shape
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, hd)


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      k_offset=0, impl="auto"):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Returns (B, Sq, H, hd).

    Query i sits at position ``q_offset + i`` and key j at ``k_offset +
    j``. With both offsets 0 the call goes to ``ops.flash_attention``;
    neither the Pallas kernel nor the port's takes offsets, so nonzero
    offsets run the plain masked online softmax over global positions on
    any device, as the reference's pure-JAX path does."""
    if q_offset == 0 and k_offset == 0:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl=impl)
    dev = q.device
    q_pos = q_offset + torch.arange(q.shape[1], device=dev)
    k_pos = k_offset + torch.arange(k.shape[1], device=dev)
    qf = scaled_queries(q, k.shape[2])
    m, l, acc = softmax_state(qf)
    s = block_scores(qf, k, q_pos, k_pos, causal, window)
    _, l, acc = merge_block(m, l, acc, s, v)
    return finish(l, acc, q.dtype)


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
