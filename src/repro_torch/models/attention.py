"""Attention (own copy of ``repro.models.attention``): the full-sequence
path for prefill, and the one-token path against a cache for decode.

The reference runs its full-sequence path as a pure-JAX chunked online
softmax and validates its Pallas kernel against it; the port routes the
same function through the kernel op itself (``ops.flash_attention``:
the hand-written CUDA kernel on the card, the plain version on the
CPU). Decode attention is one query row against the cache and stays
plain torch, as the reference's pure-jnp ``decode_attention`` is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                      k_offset=0, impl="auto"):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). Returns (B, Sq, H, hd).

    Positions start at 0 for queries and keys, which is every call on
    the serving path; the offsets of the reference's signature (ring
    attention, chunked prefill) raise until a slice needs them."""
    if q_offset != 0 or k_offset != 0:
        raise NotImplementedError(
            "chunked_attention with nonzero q_offset/k_offset waits for "
            "the pod slice's ring attention (ROADMAP.md §1)")
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl=impl)


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
