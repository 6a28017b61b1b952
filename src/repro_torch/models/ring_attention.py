"""Ring attention: context parallelism over a mesh axis (the port of
``repro.models.ring_attention``).

q, k and v are split on the sequence dim over the axis, each rank
holding a contiguous S/P-token segment in rank order. Over P steps each
rank keeps its q segment while the k/v segments rotate round the ring
(``batch_isend_irecv`` to the next rank); each incoming block is merged
into an online softmax, as the attention kernel's inner loop merges its
tiles. The causal mask is built from global positions: at step t a rank
holds the segment of rank (idx - t) mod P. A fully masked block still
rotates, so the ring stays in lockstep.

Each step moves the local K/V (2 * S/P * KV * hd elements) to the next
rank: 2 * S * KV * hd per rank per layer, whatever P is, while peak
memory stays at two segments (an all-gather of K/V moves as much and
holds the full S).

Plain torch with no kernel, as the reference's body is pure ``jnp``;
the softmax merge is ``models.attention``'s, in f32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.models import attention


def ring_attention_local(q, k, v, *, group=None, causal=True):
    """The per-rank body. q: (B, Sq_local, H, hd); k, v: (B, Sk_local,
    KV, hd): this rank's segments of a sequence split over ``group`` in
    rank order (``None``: one rank). Returns (B, Sq_local, H, hd).

    The last rotation of the reference's loop, whose blocks nothing
    reads, is skipped; on one rank nothing is sent."""
    P = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    Sq, Sk = q.shape[1], k.shape[1]
    dev = q.device
    q_pos = idx * Sq + torch.arange(Sq, device=dev)
    qf = attention.scaled_queries(q, k.shape[2])
    m, l, acc = attention.softmax_state(qf)
    kc, vc = k, v
    for t in range(P):
        src = (idx - t) % P          # the rank whose segment is held now
        k_pos = src * Sk + torch.arange(Sk, device=dev)
        s = attention.block_scores(qf, kc, q_pos, k_pos, causal, None)
        m, l, acc = attention.merge_block(m, l, acc, s, vc)
        if t < P - 1:
            kc = sharding.ring_shift(kc, group)
            vc = sharding.ring_shift(vc, group)
    return attention.finish(l, acc, q.dtype)


def ring_attention(q, k, v, *, mesh, axis="model", causal=True,
                   batch_axis=None):
    """q: (B, S, H, hd), k, v: (B, S, KV, hd), the GLOBAL tensors on every
    rank. Runs the body on this rank's segment of the sequence over
    ``axis`` (and its batch shard over ``batch_axis``), then gathers the
    result: every rank gets the global (B, S, H, hd), as the reference's
    global array gives it."""
    spec = (batch_axis, axis, None, None)
    q, k, v = (sharding.local_shard(t, spec, mesh) for t in (q, k, v))
    out = ring_attention_local(q, k, v,
                               group=sharding.axis_group(mesh, axis),
                               causal=causal)
    out = sharding.all_gather(out, mesh, axis, dim=1)
    if batch_axis is not None:
        out = sharding.all_gather(out, mesh, batch_axis, dim=0)
    return out
