"""Block-level init/apply/prefill/decode dispatch (own copy of
``repro.models.blocks`` for the kinds the port runs).

Block kinds: ``attn`` (GQA self-attention, optional sliding window
``cfg.window``), ``local_attn`` (the same with the recurrentgemma local
window ``cfg.rglru.window``), ``rglru`` (the RG-LRU recurrent block),
each followed by its MLP (dense, or MoE when ``cfg.moe`` is set); and
``mamba2`` (SSD, followed by an MLP only when ``d_ff`` > 0). Every block
is pre-norm residual. The MoE's router load-balance loss comes back from
``block_apply``; decode runs the MLP on (B, 1, d), so T = B takes the
MoE's dense-local branch. The reference's ``cross_attn`` and ``xdec``
raise ``NotImplementedError`` naming the ``ROADMAP.md`` item that ports
them.

``ctx`` carries ``impl`` (the kernel ops' ``impl=``, default "auto")
and, for prefill, ``max_len`` (the decode caches' length).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, common, mlp, rglru, ssm

_UNPORTED = {
    "cross_attn": "the vision/audio slice (ROADMAP.md §1: remaining block "
                  "kinds and configs)",
    "xdec": "the vision/audio slice (ROADMAP.md §1: remaining block kinds "
            "and configs)",
}


def _unported(kind):
    if kind in _UNPORTED:
        return NotImplementedError(
            f"block kind {kind!r} is not ported yet; it waits for "
            f"{_UNPORTED[kind]}")
    return ValueError(kind)


# ---------------------------------------------------------------------------
# Attention sub-layer
# ---------------------------------------------------------------------------

def attn_init(gen, cfg):
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
    return p


def _qkv(p, cfg, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
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


def attn_apply(p, cfg, x, *, causal=True, window=None, impl="auto"):
    return _attn_seq(p, cfg, x, causal=causal, window=window, impl=impl)[0]


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
    if kind in ("attn", "local_attn", "rglru"):
        p = {"norm1": dnorm}
        if kind == "rglru":
            p["rec"] = rglru.init(gen, cfg)
        else:
            p["attn"] = attn_init(gen, cfg)
        m = mlp_init(gen, cfg)
        if m is not None:
            p["norm2"] = dnorm.clone()
            p["mlp"] = m
        return p
    if kind == "mamba2":
        p = {"norm1": dnorm, "ssm": ssm.init(gen, cfg)}
        if cfg.d_ff:
            p["norm2"] = dnorm.clone()
            p["mlp"] = mlp_init(gen, cfg)
        return p
    raise _unported(kind)


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


def block_apply(p, cfg, kind, x, ctx):
    """x: (B, S, d). ctx: dict(causal, impl). Returns (x_out, aux_loss)."""
    impl = ctx.get("impl", "auto")
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn_apply(p["attn"], cfg, h, causal=ctx.get("causal", True),
                           window=_window_for(cfg, kind), impl=impl)
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + ssm.forward(p["ssm"], cfg, h, impl=impl)
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + rglru.forward(p["rec"], cfg, h)[0]
    else:
        raise _unported(kind)
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
        raise _unported(kind)
    return _mlp_residual(p, cfg, x)[0], cache


def block_cache_init(cfg, kind, batch, max_len, dtype, device):
    KV, hd = cfg.n_kv, cfg.resolved_head_dim
    if kind in ("attn", "local_attn"):
        window = _window_for(cfg, kind)
        length = max_len if window is None else min(window, max_len)
        return {"k": torch.zeros((batch, length, KV, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, length, KV, hd), dtype=dtype,
                                 device=device),
                "kpos": torch.full((length,), -1, dtype=torch.int32,
                                   device=device)}
    if kind == "mamba2":
        return ssm.init_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_cache(cfg, batch, dtype, device)
    raise _unported(kind)


def block_decode(p, cfg, kind, cache, x, pos, ctx):
    """x: (B, d) one token. Returns (x_out, cache), the cache updated in
    place."""
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = attn_decode(p["attn"], cfg, cache, h, pos,
                               window=_window_for(cfg, kind))
        x = x + y
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = ssm.decode_step(p["ssm"], cfg, cache, h)
        x = x + y
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = rglru.decode_step(p["rec"], cfg, cache, h)
        x = x + y
    else:
        raise _unported(kind)
    if "mlp" in p:
        h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
        y, _ = mlp_apply(p["mlp"], cfg, h[:, None])
        x = x + y[:, 0]
    return x, cache
