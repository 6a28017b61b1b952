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
``mamba2`` (SSD, followed by an MLP only when ``d_ff`` > 0); and, port
only, DeepSeek-V3's ``mla_dense`` and ``mla_moe`` (``models.mla``'s
latent attention, then the dense MLP at ``d_ff`` or the sigmoid-routed
MoE, ``mlp.sigmoid_moe_apply``), which train and run forward but serve
nothing (no latent cache) and take no ``Dist``. Every block is pre-norm
residual. Cross attention applies no rope and no mask, and
scales its output by ``tanh(gate)`` (a learned f32 scalar, 0 at init, so
a fresh model ignores ``aux``); its decode reads K/V computed once from
``aux`` at prefill. The MoE's router load-balance loss comes back from
``block_apply``; decode runs the MLP on (B, 1, d), so T = B takes the
MoE's dense-local branch.

``ctx`` carries ``impl`` (the kernel ops' ``impl=``, default "auto"),
``causal``, ``aux`` (what cross attention reads), ``dist`` (``mlp.Dist``;
default ``mlp.NO_DIST``: the MoE's expert parallelism, and the mesh over
which attention params that hold the rank's query heads, and a dense
MLP's that hold its ff slice, sum their parts (``_heads``,
``transformer.for_use``)),
``q_offset`` (``block_apply``: the first position of self-attention's
rope and mask), ``moe_loads`` (a list, where the caller wants the
``mla_moe`` blocks' expert loads for their routers' bias update:
``(bias, loads)`` appended per block), ``attn_opts`` (``attention.AttnOpts``, the reference's
§Perf options of its chunked attention: ``causal_skip`` reaches causal
self-attention only, never the encoder or cross attention, as in the
reference; ``pv_bf16`` every call) and, for prefill, ``max_len`` (the
decode caches' length).
"""
from __future__ import annotations

import torch

from repro_torch import sharding
from repro_torch.models import attention, common, mla, mlp, rglru, ssm

MLA_KINDS = ("mla_dense", "mla_moe")


def _refuse_mla(kind, what):
    raise ValueError(
        f"{kind} blocks (MLA) cannot {what}: decode needs a cache of the "
        f"latent c and k_pe, which the port does not have; train them, or "
        f"run them forward (transformer.forward), instead")


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


class _Heads:
    """A rank's share of tensor-parallel attention (``_heads``): the
    mesh and model axis its ``wo`` rows are summed over, and ``kv``, the
    kv heads its query heads read of the k and v it computes: None where
    it holds its own kv heads (KV splits over the axis), else a slice of
    one kv head, or an index tensor, one kv head a query head."""

    def __init__(self, mesh, axis, kv):
        self.mesh, self.axis, self.kv = mesh, axis, kv

    def vary(self, t):
        """A replica entering the rank's heads (``sharding.pvary``)."""
        return sharding.pvary(t, self.mesh, self.axis)

    def select(self, t):
        """The kv heads (dim 2 of (B, S, KV, hd)) the rank's queries
        read."""
        if self.kv is None:
            return t
        if isinstance(self.kv, slice):
            return t[:, :, self.kv]
        return t.index_select(2, self.kv.to(t.device))


def _heads(p, cfg, dist):
    """None where the attention params ``p`` hold every query head (one
    process, or heads that do not split over the model axis, gathered
    whole on every rank); else the rank's ``_Heads``: its ``H / m``
    query heads from ``r * H / m``, and its kv heads where ``wk`` splits
    over the axis (KV divides m), else of every kv head the ones its
    queries read, ``h // (H // KV)``."""
    Hl = p["wq"].shape[-2]
    if Hl == cfg.n_heads:
        return None
    H, KV = cfg.n_heads, cfg.n_kv
    kv = None
    if p["wk"].shape[-2] == KV:
        # KV does not divide m, so neither does a rank's query count hold
        # whole groups of H // KV: its queries read one kv head, or an
        # uneven run of them
        g = H // KV
        q0 = sharding.axis_index(dist.mesh, dist.model_axis) * Hl
        kv = (slice(q0 // g, q0 // g + 1) if g % Hl == 0
              else (q0 + torch.arange(Hl)) // g)
    return _Heads(dist.mesh, dist.model_axis, kv)


def _qkv(p, cfg, x, kv_src=None, heads=None):
    """q from ``x``; k and v from ``kv_src`` (``x`` when None). Under
    tensor-parallel ``heads`` the inputs enter through ``pvary`` (the
    column-parallel projections' input: its cotangent summed over the
    model axis), as do the leaves that every rank holds whole but reads
    only in part: ``q_norm``/``k_norm`` (each rank normalizes its own
    heads), and ``wk``/``wv``/``bk``/``bv`` where KV does not split (each
    rank reads some of the kv heads it computes)."""
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    bk, bv = p.get("bk"), p.get("bv")
    if heads is not None:
        same = kv_src is None
        x = heads.vary(x)
        kv_src = x if same else heads.vary(kv_src)
        if heads.kv is not None:
            wk, wv = heads.vary(wk), heads.vary(wv)
            if cfg.qkv_bias:
                bk, bv = heads.vary(bk), heads.vary(bv)
    kv_src = x if kv_src is None else kv_src
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("btd,dhk->bthk", kv_src, wk)
    v = torch.einsum("btd,dhk->bthk", kv_src, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if heads is not None:
            qn, kn = heads.vary(qn), heads.vary(kn)
        q = common.rms_norm(q, qn, cfg.norm_eps)
        k = common.rms_norm(k, kn, cfg.norm_eps)
    return q, k, v


def _out(p, y, heads, eq):
    """The output projection ``einsum(eq, y, wo)``: row-parallel under
    tensor-parallel ``heads``, the ranks' parts summed over the model
    axis (``sharding.psum``; the cotangent passes through whole)."""
    y = torch.einsum(eq, y, p["wo"])
    if heads is not None:
        y = sharding.psum(y, heads.mesh, heads.axis)
    return y


def _attn_seq(p, cfg, x, *, causal, window, impl, q_offset=0,
              dist=mlp.NO_DIST, opts=attention.AttnOpts()):
    """Self-attention over the whole sequence, its positions from
    ``q_offset``: the output and the roped k and v (every kv head the
    rank computes: its own, or all where KV does not split). As in the
    reference, the offset shifts the rope of q and k and the queries'
    mask positions; the keys' mask positions start at 0."""
    heads = _heads(p, cfg, dist)
    q, k, v = _qkv(p, cfg, x, heads=heads)
    pos = q_offset + torch.arange(x.shape[1], device=x.device)
    q = common.apply_rope(q, pos[None], cfg.rope_theta)
    k = common.apply_rope(k, pos[None], cfg.rope_theta)
    ka, va = (k, v) if heads is None else (heads.select(k), heads.select(v))
    out = attention.chunked_attention(
        q.contiguous(), ka.contiguous(), va.contiguous(), causal=causal,
        window=window, q_offset=q_offset, impl=impl,
        causal_skip=opts.causal_skip and causal, pv_bf16=opts.pv_bf16)
    return _out(p, out, heads, "bshk,hkd->bsd"), k, v


def _gated(p, y):
    """Cross attention's output scale: ``tanh(gate)`` in f32, cast to
    y's dtype before the product, as the reference casts it (on the
    summed output: every rank scales the whole)."""
    return torch.tanh(p["gate"]).to(y.dtype) * y


def attn_apply(p, cfg, x, *, kv_src=None, causal=True, window=None,
               impl="auto", q_offset=0, dist=mlp.NO_DIST,
               opts=attention.AttnOpts()):
    """Self-attention over ``x`` (positions from ``q_offset``); with
    ``kv_src`` (B, T, d), cross attention from ``x`` to it: no rope, no
    causal mask, gated. ``dist``: the rank's heads where ``p`` holds
    them (``_heads``)."""
    if kv_src is None:
        return _attn_seq(p, cfg, x, causal=causal, window=window,
                         impl=impl, q_offset=q_offset, dist=dist,
                         opts=opts)[0]
    heads = _heads(p, cfg, dist)
    q, k, v = _qkv(p, cfg, x, kv_src, heads)
    if heads is not None:
        k, v = heads.select(k), heads.select(v)
    out = attention.chunked_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=False,
                                      window=window, impl=impl,
                                      pv_bf16=opts.pv_bf16)
    return _gated(p, _out(p, out, heads, "bshk,hkd->bsd"))


def _attn_prefill(p, cfg, x, *, window, max_len, causal=True, impl="auto",
                  dist=mlp.NO_DIST, opts=attention.AttnOpts()):
    """Like attn_apply but also returns the KV cache after S tokens (the
    kv heads the rank computes)."""
    B, S, _ = x.shape
    y, k, v = _attn_seq(p, cfg, x, causal=causal, window=window, impl=impl,
                        dist=dist, opts=opts)
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


def _seq_split(cache):
    """The rank's slot count of a KV cache whose slots are split over
    "model" (``cache_specs_tree``'s sequence layout, at batch 1), or
    None where it holds every slot (``kpos`` is whole either way)."""
    n, whole = cache["k"].shape[1], cache["kpos"].shape[0]
    return None if n == whole else n


def _every_head(t, heads):
    """Every head of ``t`` (B, heads, hd), which holds the rank's own
    where ``heads`` splits them: gathered over the model axis."""
    if heads is None:
        return t
    return sharding.all_gather(t, heads.mesh, heads.axis, 1)


def _cached_heads(t, heads, cfg):
    """The kv heads (dim 2 of (B, S, KV, hd)) of a cache that the rank's
    queries read: ``heads.select``'s of every kv head; where the rank
    computes its own kv heads (``heads.kv`` None), the cache itself, or
    its own block of a cache holding every kv head."""
    if heads is None:
        return t
    if heads.kv is not None:
        return heads.select(t)
    if t.shape[2] != cfg.n_kv:
        return t
    n = t.shape[2] // sharding.axis_size(heads.mesh, heads.axis)
    return t.narrow(2, sharding.axis_index(heads.mesh, heads.axis) * n, n)


def _split_decode(q, cache, pos, window, heads, dist):
    """One token's attention against a cache whose slots are split over
    "model": every head's softmax part over the rank's slots
    (``attention.decode_attention_part``), combined over the axis in
    f32 (``sharding.softmax_combine``); q (B, H, hd) every head's. The
    rank's query heads of the output where ``heads`` holds them."""
    n = cache["k"].shape[1]
    r = sharding.axis_index(dist.mesh, dist.model_axis)
    m, l, o = attention.decode_attention_part(
        q, cache["k"], cache["v"], cache["kpos"][r * n:(r + 1) * n], pos,
        window=window)
    y = sharding.softmax_combine(m, l, o, dist.mesh,
                                 dist.model_axis).to(q.dtype)
    if heads is not None:
        h = y.shape[1] // sharding.axis_size(heads.mesh, heads.axis)
        y = y.narrow(1, sharding.axis_index(heads.mesh, heads.axis) * h, h)
    return y


def attn_decode(p, cfg, cache, x, pos, *, window=None, dist=mlp.NO_DIST):
    """x: (B, d) one token; cache: {k, v, kpos}, written in place at the
    token's slot. Returns (y, cache). Where the cache holds the rank's
    slots of a sequence split over "model", the token's k and v (every
    kv head) are written by the rank that owns its slot (a window's ring
    slot ``pos % W``), and every head's query attends over every rank's
    slots (``_split_decode``)."""
    heads = _heads(p, cfg, dist)
    q, k, v = _qkv(p, cfg, x[:, None], heads=heads)
    posv = torch.full((1, 1), pos, device=x.device)
    q = common.apply_rope(q, posv, cfg.rope_theta)
    k = common.apply_rope(k, posv, cfg.rope_theta)
    S = cache["kpos"].shape[0]
    slot = pos % S if window is not None else pos
    k, v = k[:, 0], v[:, 0]
    if k.shape[1] != cache["k"].shape[2]:
        # its own kv heads computed, every one cached (a sequence layout)
        k, v = _every_head(k, heads), _every_head(v, heads)
    n = _seq_split(cache)
    first = 0 if n is None else \
        sharding.axis_index(dist.mesh, dist.model_axis) * n
    if n is None or first <= slot < first + n:     # the slot's owner
        cache["k"][:, slot - first] = k
        cache["v"][:, slot - first] = v
    cache["kpos"][slot] = pos
    if n is not None:
        y = _split_decode(_every_head(q[:, 0], heads), cache, pos, window,
                          heads, dist)
        return _out(p, y, heads, "bhk,hkd->bd"), cache
    y = attention.decode_attention(
        q[:, 0], _cached_heads(cache["k"], heads, cfg),
        _cached_heads(cache["v"], heads, cfg), cache["kpos"], pos,
        window=window)
    return _out(p, y, heads, "bhk,hkd->bd"), cache


def cross_decode(p, cfg, cross_kv, x, dist=mlp.NO_DIST):
    """Cross attention for one decode token against the K/V that
    ``precompute_cross_kv`` made at prefill: the plain ``decode_attention``
    with every slot visible (no kernel), or its parts over the rank's
    slots where they are split over "model" (``_split_decode``)."""
    heads = _heads(p, cfg, dist)
    q = torch.einsum("bd,dhk->bhk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = common.rms_norm(q, p["q_norm"], cfg.norm_eps)
    if _seq_split(cross_kv) is not None:
        y = _split_decode(_every_head(q, heads), cross_kv, 2 ** 30, None,
                          heads, dist)
    else:
        y = attention.decode_attention(
            q, _cached_heads(cross_kv["k"], heads, cfg),
            _cached_heads(cross_kv["v"], heads, cfg), cross_kv["kpos"],
            2 ** 30)
    y = _out(p, y, heads, "bhk,hkd->bd")
    if "gate" in p:
        y = _gated(p, y)
    return y


def precompute_cross_kv(p, cfg, aux):
    """aux: (B, T, d) encoder/vision embeddings -> the decode-side K/V
    cache {k, v, kpos} (the kv heads the rank computes)."""
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


def mlp_apply(p, cfg, x, dist=mlp.NO_DIST):
    """Returns (y, aux_loss): the MoE's router load-balance loss, 0 for
    the dense MLP. ``dist``: the MoE's expert parallelism (``mlp.Dist``;
    x is then this rank's batch shard)."""
    if p is None:
        return torch.zeros_like(x), torch.zeros((), device=x.device)
    if cfg.moe is not None:
        return mlp.moe_apply(p, x, cfg.moe, cfg.act, dist)
    # tensor-parallel where p holds the rank's ff slice
    tp = dist if p["wi"].shape[-1] != cfg.d_ff else mlp.NO_DIST
    return mlp.dense_mlp_apply(p, x, cfg.act, tp), torch.zeros(
        (), device=x.device)


# ---------------------------------------------------------------------------
# Block init / apply / prefill / decode
# ---------------------------------------------------------------------------

def _mla_init(gen, cfg, kind):
    dnorm = torch.zeros((cfg.d_model,), device=gen.device)
    p = {"norm1": dnorm, "attn": mla.init(gen, cfg), "norm2": dnorm.clone()}
    if kind == "mla_dense":
        p["mlp"] = mlp.dense_mlp_init(gen, cfg.d_model, cfg.d_ff,
                                      common.dtype_of(cfg))
    else:
        p["mlp"] = mlp.sigmoid_moe_init(gen, cfg.moe, cfg.d_model,
                                        common.dtype_of(cfg))
    return p


def _mla_apply(p, cfg, kind, x, ctx):
    """An ``mla_dense`` / ``mla_moe`` block: (x_out, the router's
    balance loss, 0 for the dense one)."""
    if ctx.get("dist", mlp.NO_DIST).enabled:
        raise ValueError(
            f"{kind} blocks take no Dist: MLA has no tensor-parallel heads "
            f"and the sigmoid-routed MoE no expert exchange; a card holds "
            f"its share of the experts (moe.experts_held) instead")
    h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + mla.apply(p["attn"], cfg, h, q_offset=ctx.get("q_offset", 0),
                      impl=ctx.get("attn_impl", ctx.get("impl", "auto")))
    h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "mla_dense":
        return x + mlp.dense_mlp_apply(p["mlp"], h, cfg.act), torch.zeros(
            (), device=x.device)
    y, bal, loads = mlp.sigmoid_moe_apply(p["mlp"], h, cfg.moe, cfg.act)
    if ctx.get("moe_loads") is not None:
        ctx["moe_loads"].append((p["mlp"]["bias"], loads))
    return x + y, bal


def block_init(gen, cfg, kind):
    if kind in MLA_KINDS:
        return _mla_init(gen, cfg, kind)
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


def _mlp_residual(p, cfg, x, dist=mlp.NO_DIST):
    """The block's MLP sub-layer: (x_out, aux_loss)."""
    if "mlp" not in p:
        return x, torch.zeros((), device=x.device)
    h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
    y, aux = mlp_apply(p["mlp"], cfg, h, dist)
    return x + y, aux


def _cross_residual(p, cfg, x, norm, aux, impl, dist, opts):
    h = common.rms_norm(x, norm, cfg.norm_eps)
    return x + attn_apply(p, cfg, h, kv_src=aux, impl=impl, dist=dist,
                          opts=opts)


def block_apply(p, cfg, kind, x, ctx):
    """x: (B, S, d). ctx: dict(causal, aux, impl, attn_impl, dist,
    q_offset, attn_opts); ``attn_impl`` (default ``impl``) routes the
    attention, ``impl`` the SSD. Returns (x_out, aux_loss)."""
    if kind in MLA_KINDS:
        return _mla_apply(p, cfg, kind, x, ctx)
    impl = ctx.get("impl", "auto")
    attn_impl = ctx.get("attn_impl", impl)
    q_off = ctx.get("q_offset", 0)
    dist = ctx.get("dist", mlp.NO_DIST)
    opts = ctx.get("attn_opts", attention.AttnOpts())
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn_apply(p["attn"], cfg, h, causal=ctx.get("causal", True),
                           window=_window_for(cfg, kind), impl=attn_impl,
                           q_offset=q_off, dist=dist, opts=opts)
    elif kind == "cross_attn":
        x = _cross_residual(p["attn"], cfg, x, p["norm1"], ctx["aux"],
                            attn_impl, dist, opts)
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + attn_apply(p["attn"], cfg, h, causal=True, impl=attn_impl,
                           q_offset=q_off, dist=dist, opts=opts)
        x = _cross_residual(p["xattn"], cfg, x, p["norm_x"], ctx["aux"],
                            attn_impl, dist, opts)
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + ssm.forward(p["ssm"], cfg, h, impl=impl)
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + rglru.forward(p["rec"], cfg, h)[0]
    else:
        raise ValueError(kind)
    return _mlp_residual(p, cfg, x, dist)


def cache_block(cache, cfg, dist, seq_axis_model):
    """One block's caches as its prefill computed them (every slot, the
    kv heads its attention computed, every state) cut to the rank's
    block of ``sharding.cache_specs_tree(seq_axis_model=)``'s spec
    (copies, so nothing keeps the whole alive): kv heads or slots, an
    SSM state's hd or H, over "model". k and v computed on the rank's
    own kv heads move to its slots of every head by an all-to-all over
    the axis. The batch is the rank's rows already; the caches as they
    are where "model" splits no work (``mlp.model_split``)."""
    if not mlp.model_split(dist):
        return cache
    mesh, axis = dist.mesh, dist.model_axis
    m = sharding.axis_size(mesh, axis)

    def one(path, t):
        whole = list(t.shape)
        kv = path[-1] in ("k", "v")
        if kv:
            whole[2] = cfg.n_kv
        # the spec of each dim after the batch
        spec = sharding.cache_leaf_spec((1,) + tuple(whole), mesh,
                                        seq_axis_model)[2:]
        if kv and t.shape[2] != cfg.n_kv:        # its own kv heads
            if spec[0] is not None:              # to its slots, every head
                B, S, KV, hd = t.shape
                t = sharding.all_to_all(t.reshape(B, m, S // m, KV, hd)
                                        .movedim(1, 0).contiguous(),
                                        mesh, axis)
                return t.movedim(0, 2).reshape(B, S // m, m * KV, hd)
            if spec[1] is not None:
                return t
            return sharding.all_gather(t, mesh, axis, 2)
        if all(e is None for e in spec):
            return t
        return sharding.local_shard(t, (None,) + spec, mesh).clone()

    return sharding.map_with_path(one, cache)


def block_prefill(p, cfg, kind, x, ctx):
    """x: (B, S, d). Returns (x_out, cache) — cache matches block_decode,
    the rank's block of it under a ``Dist`` (``cache_block``, with
    ``ctx["seq_axis_model"]``)."""
    if kind in MLA_KINDS:
        _refuse_mla(kind, "prefill")
    max_len = ctx.get("max_len", x.shape[1])
    impl = ctx.get("impl", "auto")
    dist = ctx.get("dist", mlp.NO_DIST)
    opts = ctx.get("attn_opts", attention.AttnOpts())
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = _attn_prefill(p["attn"], cfg, h,
                                 window=_window_for(cfg, kind),
                                 max_len=max_len, impl=impl, dist=dist,
                                 opts=opts)
        x = x + y
    elif kind == "cross_attn":
        x = _cross_residual(p["attn"], cfg, x, p["norm1"], ctx["aux"], impl,
                            dist, opts)
        cache = precompute_cross_kv(p["attn"], cfg, ctx["aux"])
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, self_c = _attn_prefill(p["attn"], cfg, h, window=None,
                                  max_len=max_len, impl=impl, dist=dist,
                                  opts=opts)
        x = _cross_residual(p["xattn"], cfg, x + y, p["norm_x"],
                            ctx["aux"], impl, dist, opts)
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
    cache = cache_block(cache, cfg, dist, ctx.get("seq_axis_model", False))
    return _mlp_residual(p, cfg, x, dist)[0], cache


def block_cache_init(cfg, kind, batch, max_len, dtype, device):
    if kind in MLA_KINDS:
        _refuse_mla(kind, "decode")
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
    if kind in MLA_KINDS:
        _refuse_mla(kind, "decode")
    dist = ctx.get("dist", mlp.NO_DIST)
    if kind in ("attn", "local_attn"):
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = attn_decode(p["attn"], cfg, cache, h, pos,
                               window=_window_for(cfg, kind), dist=dist)
        x = x + y
    elif kind == "cross_attn":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        x = x + cross_decode(p["attn"], cfg, cache, h, dist)
    elif kind == "xdec":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, _ = attn_decode(p["attn"], cfg, cache["self"], h, pos, dist=dist)
        x = x + y
        h = common.rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + cross_decode(p["xattn"], cfg, cache["cross"], h, dist)
    elif kind == "mamba2":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = ssm.decode_step(p["ssm"], cfg, cache, h, dist)
        x = x + y
    elif kind == "rglru":
        h = common.rms_norm(x, p["norm1"], cfg.norm_eps)
        y, cache = rglru.decode_step(p["rec"], cfg, cache, h)
        x = x + y
    else:
        raise ValueError(kind)
    if "mlp" in p:
        h = common.rms_norm(x, p["norm2"], cfg.norm_eps)
        y, _ = mlp_apply(p["mlp"], cfg, h[:, None], dist)
        x = x + y[:, 0]
    return x, cache
