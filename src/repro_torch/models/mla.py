"""Multi-head latent attention with no q LoRA (DeepSeek-V2/V3; the
``mla_dense`` and ``mla_moe`` blocks' attention). Port only: the
reference has no MLA.

For one token's input x (after the block's pre-norm), with
``cfg.mla`` = (r, nope, rope, dv):

  q = x W_q                       (d -> H (nope + rope))
  [c, k_pe] = x W_kva             (d -> r + rope); c = RMSNorm(c)
  [k_nope, v] = c W_kvb           (r -> H (nope + dv))
  q_pe, k_pe roped (k_pe one head, shared by all H)
  q = [q_nope, q_pe], k = [k_nope, k_pe]; scores q.k / sqrt(nope + rope)
  o = softmax(scores) v (causal) -> W_o (H dv -> d)

The attention runs on the chunked route (``attention.chunked_attention``
sends it there: dv differs from the queries' width, which no kernel
takes), with ``causal_skip``: the chunks above the diagonal, which
contribute exactly nothing, are not computed.

Departures from the published checkpoints: the rope dimensions rotate
half-split (``common.apply_rope``), where DeepSeek's store them
interleaved (with seeded weights a fixed permutation of ``wq``'s and
``wkva``'s rope columns; loading a checkpoint would permute them), and
the norm scales are ``(1 + scale)`` as the port's every RMS norm (a
checkpoint's weight w loads as w - 1).

Spans (``obs.trace.active()``): ``mla.proj`` around the projections
into the attention (q, kv_a, the norm, kv_b, the rope) and again around
the output projection.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common
from repro_torch.obs import trace as obs_trace

# the latent's RMS norm: the published model's kv_a_layernorm, built with
# its norm class's default (its config's rms_norm_eps reaches the
# layers' norms only)
KV_NORM_EPS = 1e-6


def init(gen, cfg):
    d, H, m = cfg.d_model, cfg.n_heads, cfg.mla
    dtype = common.dtype_of(cfg)
    r = m.kv_lora_rank
    return {
        "wq": common.dense_init(gen, (d, H, m.qk_head_dim), dtype, fan_in=d),
        "wkva": common.dense_init(gen, (d, r + m.qk_rope_head_dim), dtype),
        "kv_norm": torch.zeros((r,), device=gen.device),
        "wkvb": common.dense_init(
            gen, (r, H, m.qk_nope_head_dim + m.v_head_dim), dtype, fan_in=r),
        "wo": common.dense_init(gen, (H, m.v_head_dim, d), dtype,
                                fan_in=H * m.v_head_dim),
    }


def qkv(p, cfg, x, q_offset=0):
    """x (B, S, d) -> q, k (B, S, H, nope + rope) and v (B, S, H, dv),
    q and k roped at positions from ``q_offset``."""
    m = cfg.mla
    B, S, _ = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    c, k_pe = (x @ p["wkva"]).split([m.kv_lora_rank, rope], dim=-1)
    c = common.rms_norm(c, p["kv_norm"], KV_NORM_EPS)
    k_nope, v = torch.einsum("bsr,rhk->bshk", c, p["wkvb"]).split(
        [nope, m.v_head_dim], dim=-1)
    pos = (q_offset + torch.arange(S, device=x.device))[None]
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    q_pe = common.apply_rope(q_pe, pos, cfg.rope_theta)
    k_pe = common.apply_rope(k_pe[:, :, None], pos, cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(-1, -1, cfg.n_heads, -1)], dim=-1)
    return q, k, v.contiguous()


def apply(p, cfg, x, *, q_offset=0, impl="auto"):
    """Causal self-attention of x (B, S, d), positions from
    ``q_offset``: (B, S, d)."""
    tr = obs_trace.active()
    with tr.span("mla.proj", device=x.device):
        q, k, v = qkv(p, cfg, x, q_offset)
    o = attention.chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                                    causal_skip=True, impl=impl)
    with tr.span("mla.proj", device=x.device):
        return torch.einsum("bshk,hkd->bsd", o, p["wo"])
