"""Block-level init/apply/prefill/decode dispatch (own copy of
``repro.models.blocks``).

Block kinds: ``attn`` (GQA self-attention, optional sliding window
``cfg.window``; bidirectional when ``ctx["causal"]`` is false, as in the
encoder, rope kept), ``local_attn`` (the same with the recurrentgemma
local window ``cfg.rglru.window``), ``rglru`` (the RG-LRU recurrent
block), ``cross_attn`` (attention from the tokens to ``ctx["aux"]``, the
vision embeddings or the encoder's output), each followed by its MLP
(dense, or MoE when ``cfg.moe`` is set); ``xdec`` (the encoder-decoder's
decoder block: causal self-attention, cross attention, MLP); and
``mamba2`` (SSD, followed by an MLP only when ``d_ff`` > 0). Every block
is pre-norm residual. Cross attention applies no rope and no mask, and
scales its output by ``tanh(gate)`` (a learned f32 scalar, 0 at init, so
a fresh model ignores ``aux``); its decode reads K/V computed once from
``aux`` at prefill. The MoE's router load-balance loss comes back from
``block_apply``; decode runs the MLP on (B, 1, d), so T = B takes the
MoE's dense-local branch.

``ctx`` carries ``impl`` (the kernel ops' ``impl=``, default "auto"),
``causal``, ``aux`` (what cross attention reads) and, for prefill,
``max_len`` (the decode caches' length).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common, mlp, rglru, ssm


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------

def attn_init(gen, cfg, cross=False):
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv
    hd = cfg.resolved_head_dim
    dtype = common.dtype_of(cfg)
    dev = gen.device
    p = {
        "wq": common.dense_init(gen, (d, H, hd), dtype, fan_in=d),
        "wk": common.dense_init(gen, (d, KV, hd), dtype, fan_in=d),
        "wv": common.dense_init(gen, (d, KV, hd), dtype, fan_in=d),
        "wo": common.dense_init(gen, (H, hd, d), dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KV, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), device=dev)
        p["k_norm"] = torch.zeros((hd,), device=dev)
    if cross:
        p["gate"] = torch.zeros((), device=dev)
    return p


def _qkv(p, cfg, x, kv_src=None):
    """q from ``x``; k and v from ``kv_src`` (``x`` when None)."""
    kv_src = x if kv_src is None else kv_src
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", kv_src, p["wk"])
    v = torch.einsum("btd,dhk->bthk", kv_src, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_seq(p, cfg, x, *, causal, window, impl):
    """Self-attention over the whole sequence (positions from 0): the
    output and the roped k and v."""
    q, k, v = _qkv(p, cfg, x)
    pos = torch.arange(x.shape[1], device=x.device)
    q = common.apply_rope(q, pos[None], cfg.rope_theta)
    k = common.apply_rope(k, pos[None], cfg.rope_theta)
    out = attention.chunked_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window, impl=impl)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


def _gated(p, y):
    """Cross attention's output scale: ``tanh(gate)`` in f32, cast to
    y's dtype before the product, as the reference casts it."""
    return torch.tanh(p["gate"]).to(y.dtype) * y


def attn_apply(p, cfg, x, *, kv_src=None, causal=True, window=None,
               impl="auto"):
    """Self-attention over ``x``; with ``kv_src`` (B, T, d), cross
    attention from ``x`` to it: no rope, no causal mask, gated."""
    if kv_src is None:
        return _attn_seq(p, cfg, x, causal=causal, window=window,
                         impl=impl)[0]
    q, k, v = _qkv(p, cfg, x, kv_src)
    out = attention.chunked_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=False,
                                      window=window, impl=impl)
    return _gated(p, torch.einsum("bshk,hkd->bsd", out, p["wo"]))


def _attn_prefill(p, cfg, x, *, window, max_len, causal=True, impl="auto"):
    """Like attn_apply but also returns the KV cache after S tokens."""
    B, S, _ = x.shape
    y, k, v = _attn_seq(p, cfg, x, causal=causal, window=window, impl=impl)
    _, _, KV, hd = k.shape
    if window is not None and window < max_len:
        Wc = min(window, max_len)
        keep = min(S, Wc)
        # ring layout: position p lives in slot p % Wc
        slots = torch.tensor([t % Wc for t in range(S - keep, S)],
                             device=x.device)
        ck = torch.zeros((B, Wc, KV, hd), dtype=k.dtype, device=x.device)
        cv = torch.zeros((B, Wc, KV, hd), dtype=v.dtype, device=x.device)
        ck[:, slots] = k[:, S - keep:]
        cv[:, slots] = v[:, S - keep:]
        kpos = torch.full((Wc,), -1, dtype=torch.int32, device=x.device)
        kpos[slots] = torch.arange(S - keep, S, dtype=torch.int32,
                                   device=x.device)
        return y, {"k": ck, "v": cv, "kpos": kpos}
    pad = max_len - S
    return y, {
        "k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
        "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
        "kpos": torch.cat([torch.arange(S, dtype=torch.int32, device=x.device),
                           torch.full((pad,), -1, dtype=torch.int32,
                                      device=x.device)]),
    }


def attn_decode(p, cfg, cache, x, pos, *, window=None):
    """x: (B, d) one token; cache: {k, v, kpos}, written in place at the
    token's slot. Returns (y, cache)."""
    q, k, v = _qkv(p, cfg, x[:, None])
    posv = torch.full((1, 1), pos, device=x.device)
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    S = cache["k"].shape[1]
    slot = pos % S if window is not None else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][slot] = pos
    y = attention.decode_attention(q[:, 0], cache["k"], cache["v"],
                                   cache["kpos"], pos, window=window)
    return torch.einsum("bhk,hkd->bd", y, p["wo"]), cache


def cross_decode(p, cfg, cross_kv, x):
    """Cross attention for one decode token against the K/V that
    ``precompute_cross_kv`` made at prefill: the plain ``decode_attention``
    with every slot visible (no kernel)."""
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
    y = attention.decode_attention(q, cross_kv["k"], cross_kv["v"],
                                   cross_kv["kpos"], 2 ** 30)
    y = torch.einsum("bhk,hkd->bd", y, p["wo"])
    if "gate" in p:
        y = _gated(p, y)
    return y


def precompute_cross_kv(p, cfg, aux):
    """aux: (B, T, d) encoder/vision embeddings -> the decode-side K/V
    cache {k, v, kpos}."""
    k = torch.einsum("btd,dhk->bthk", aux, p["wk"])
    v = torch.einsum("btd,dhk->bthk", aux, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = common.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return {"k": k, "v": v,
            "kpos": torch.arange(aux.shape[1], dtype=torch.int32,
                                 device=aux.device)}


# ---------------------------------------------------------------------------
# MLP sub-layer dispatch: dense or MoE
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg):
    if cfg.moe is not None:
        return moe_wrap_init(gen, cfg)
    if cfg.d_ff == 0:
        return None
    return mlp.dense_mlp_init(gen, cfg.d_model, cfg.d_ff,
                              common.dtype_of(cfg))


def moe_wrap_init(gen, cfg):
    return mlp.moe_init(gen, cfg.moe, cfg.d_model, common.dtype_of(cfg))


def mlp_apply(p, cfg, x):
    """Returns (y, aux_loss): the MoE's router load-balance loss, 0 for
    the dense MLP."""
    if p is None:
        return torch.zeros_like(x), torch.zeros((), device=x.device)
    if cfg.moe is not None:
        return mlp.moe_apply(p, x, cfg.moe, cfg.act)
    return mlp.dense_mlp_apply(p, x, cfg.act), torch.zeros((),
                                                            device=x.device)


# ---------------------------------------------------------------------------
# Block init / apply / prefill / decode
# ---------------------------------------------------------------------------

def block_init(gen, cfg, kind):
    dnorm = torch.zeros((cfg.d_model,), device=gen.device)
    if kind in ("attn", "local_attn", "rglru", "cross_attn"):
        p = {"norm1": dnorm}
        if kind == "rglru":
            p["rec"] = rglru.init(gen, cfg)
        else:
            p["attn"] = attn_init(gen, cfg, cross=kind == "cross_attn")
        m = mlp_init(gen, cfg)
        if m is not None:
            p["norm2"] = dnorm.clone()
            p["mlp"] = m
        return p
    if kind == "xdec":
        return {"norm1": dnorm, "attn": attn_init(gen, cfg),
                "norm_x": dnorm.clone(),
                "xattn": attn_init(gen, cfg, cross=True),
                "norm2": dnorm.clone(), "mlp": mlp_init(gen, cfg)}
    if kind == "mamba2":
        p = {"norm1": dnorm, "ssm": ssm.init(gen, cfg)}
        if cfg.d_ff:
            p["norm2"] = dnorm.clone()
            p["mlp"] = mlp_init(gen, cfg)
        return p
    raise ValueError(kind)


def _window_for(cfg, kind):
    if kind == "local_attn":
        return cfg.rglru.window if cfg.rglru else (cfg.window or 2048)
    return cfg.window


def _mlp_residual(p, cfg, x):
    """The block's MLP sub-layer: (x_out, aux_loss)."""
    if "mlp" not in p:
        return x, torch.zeros((), device=x.device)
    h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = mlp_apply(p["mlp"], cfg, h)
    return x + y, aux


def _cross_residual(p, cfg, x, norm, aux, impl):
    h = common.rms_norm(x, norm, cfg.norm_eps)
    return x + attn_apply(p, cfg, h, kv_src=aux, impl=impl)


def block_apply(p, cfg, kind, x, ctx):
    """x: (B, S, d). ctx: dict(causal, aux, impl). Returns (x_out,
    aux_loss)."""
    impl = ctx.get("impl", "auto")
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn_apply(p["attn"], cfg, h, causal=ctx.get("causal", True),
                           window=_window_for(cfg, kind), impl=impl)
    elif kind == "cross_attn":
        x = _cross_residual(p["attn"], cfg, x, p["norm1"], ctx["aux"], impl)
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn_apply(p["attn"], cfg, h, causal=True, impl=impl)
        x = _cross_residual(p["xattn"], cfg, x, p["norm_x"], ctx["aux"],
                            impl)
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + ssm.forward(p["ssm"], cfg, h, impl=impl)
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + rglru.forward(p["rec"], cfg, h)[0]
    else:
        raise ValueError(kind)
    return _mlp_residual(p, cfg, x)


def block_prefill(p, cfg, kind, x, ctx):
    """x: (B, S, d). Returns (x_out, cache) — cache matches block_decode."""
    max_len = ctx.get("max_len", x.shape[1])
    impl = ctx.get("impl", "auto")
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = _attn_prefill(p["attn"], cfg, h,
                                 window=_window_for(cfg, kind),
                                 max_len=max_len, impl=impl)
        x = x + y
    elif kind == "cross_attn":
        x = _cross_residual(p["attn"], cfg, x, p["norm1"], ctx["aux"], impl)
        cache = precompute_cross_kv(p["attn"], cfg, ctx["aux"])
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, self_c = _attn_prefill(p["attn"], cfg, h, window=None,
                                  max_len=max_len, impl=impl)
        x = _cross_residual(p["xattn"], cfg, x + y, p["norm_x"],
                            ctx["aux"], impl)
        cache = {"self": self_c,
                 "cross": precompute_cross_kv(p["xattn"], cfg, ctx["aux"])}
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = ssm.forward(p["ssm"], cfg, h, return_cache=True,
                               impl=impl)
        x = x + y
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, h_T, conv_tail = rglru.forward(p["rec"], cfg, h)
        cache = {"h": h_T, "conv": conv_tail}
        x = x + y
    else:
        raise ValueError(kind)
    return _mlp_residual(p, cfg, x)[0], cache


def block_cache_init(cfg, kind, batch, max_len, dtype, device):
    KV, hd = cfg.n_kv, cfg.resolved_head_dim

    def kv_cache(length):
        return {"k": torch.zeros((batch, length, KV, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, length, KV, hd), dtype=dtype,
                                 device=device),
                "kpos": torch.full((length,), -1, dtype=torch.int32,
                                   device=device)}

    if kind in ("attn", "local_attn"):
        window = _window_for(cfg, kind)
        return kv_cache(max_len if window is None else min(window, max_len))
    if kind == "cross_attn":
        # filled by precompute_cross_kv at prefill
        return kv_cache(cfg.vision_tokens or cfg.enc_seq)
    if kind == "xdec":
        return {"self": kv_cache(max_len), "cross": kv_cache(cfg.enc_seq)}
    if kind == "mamba2":
        return ssm.init_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def block_decode(p, cfg, kind, cache, x, pos, ctx):
    """x: (B, d) one token. Returns (x_out, cache), the cache updated in
    place."""
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = attn_decode(p["attn"], cfg, cache, h, pos,
                               window=_window_for(cfg, kind))
        x = x + y
    elif kind == "cross_attn":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + cross_decode(p["attn"], cfg, cache, h)
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, _ = attn_decode(p["attn"], cfg, cache["self"], h, pos)
        x = x + y
        h = common.rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + cross_decode(p["xattn"], cfg, cache["cross"], h)
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = ssm.decode_step(p["ssm"], cfg, cache, h)
        x = x + y
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = rglru.decode_step(p["rec"], cfg, cache, h)
        x = x + y
    else:
        raise ValueError(kind)
    if "mlp" in p:
        h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
        y, _ = mlp_apply(p["mlp"], cfg, h[:, None])
        x = x + y[:, 0]
    return x, cache
