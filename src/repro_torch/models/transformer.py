"""Top-level model assembly: embedding -> grouped blocks -> norm -> head
(own copy of ``repro.models.transformer``).

A model is a stack of *groups*; each group is ``(pattern, repeat)`` and
its parameters are stacked on a leading ``repeat`` axis, as in the
reference, so that its parameter tree converts one to one. The
reference scans a group with ``lax.scan``; the port indexes the stacked
leaves along axis 0 in a Python loop.

Three entry points:
  ``forward``     — full-sequence -> logits
  ``prefill``     — full-sequence forward that also fills decode caches
  ``serve_step``  — one-token decode against the caches, in place

``forward`` returns the MoE blocks' router load-balance losses summed
over every block (0 for dense stacks).

Encoder-decoder (``cfg.enc_dec``): the leading groups that fall inside
``cfg.enc_layers`` form the bidirectional encoder over the stub audio
embeddings ``aux`` (``encode``); the rest form the decoder, whose
``xdec`` blocks cross-attend to the encoder's output. Vision
(``cfg.vision_tokens``): ``cross_attn`` blocks attend to the stub patch
embeddings passed as ``aux``. Encoder groups hold ``None`` for caches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.convert import tree_leaves, tree_map, tree_stack
from repro_torch.device import resolve_device
from repro_torch.models import blocks, common


def group_infos(cfg):
    """(index, pattern, repeat, is_encoder) for each group."""
    seen = 0
    out = []
    for gi, (pattern, repeat) in enumerate(cfg.groups):
        n = len(pattern) * repeat
        out.append((gi, pattern, repeat,
                    bool(cfg.enc_dec) and seen + n <= cfg.enc_layers))
        seen += n
    return out


def groups_of(cfg, *, encoder=False):
    """(index, pattern, repeat) of the decoder's groups, or with
    ``encoder`` the encoder's."""
    return [(gi, pattern, repeat)
            for gi, pattern, repeat, is_enc in group_infos(cfg)
            if is_enc == encoder]


def _layer(tree, r):
    """Layer ``r`` of a stacked tree: views, so in-place writes to a
    layer's cache land in the stacked caches."""
    return tree_map(lambda a: a[r], tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(gen, cfg):
    """Random parameters drawn from the ``torch.Generator`` ``gen``, on
    its device, in the reference's tree layout."""
    dtype = common.dtype_of(cfg)
    params = {
        "embed": common.dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                   dtype, fan_in=cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), device=gen.device),
    }
    groups = []
    for pattern, repeat in cfg.groups:
        def unit(g, pattern=pattern):
            return tuple(blocks.block_init(g, cfg, kind) for kind in pattern)
        groups.append(common.stack_init(gen, repeat, unit))
    params["groups"] = tuple(groups)
    if cfg.enc_dec:
        params["enc_norm"] = torch.zeros((cfg.d_model,), device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype)
    return params


def param_count(params):
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    """The embedding rows of ``tokens``. ``F.embedding`` rather than an
    index: its backward has a deterministic CUDA kernel, which the LM
    trainers' bit-exact gates run under."""
    return F.embedding(tokens.long(), params["embed"])


def unembed(params, cfg, x):
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = common.softcap(logits.float(), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:       # mask pad-row logits
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


def _apply_groups(params, cfg, groups, x, ctx):
    """x through every unit of ``groups`` ((index, pattern, repeat)
    triples): (x, the summed router aux losses)."""
    aux_loss = torch.zeros((), device=x.device)
    for gi, pattern, repeat in groups:
        for r in range(repeat):
            for kind, bp in zip(pattern, _layer(params["groups"][gi], r)):
                x, a = blocks.block_apply(bp, cfg, kind, x, ctx)
                aux_loss = aux_loss + a
    return x, aux_loss


def encode(params, cfg, aux_embed, *, impl="auto"):
    """Run the encoder groups bidirectionally over the stub frame
    embeddings (B, T, d). Returns (the normed encoder output, aux_loss)."""
    x, aux_loss = _apply_groups(params, cfg, groups_of(cfg, encoder=True),
                                aux_embed, {"causal": False, "impl": impl})
    return common.rms_norm(x, params["enc_norm"], cfg.norm_eps), aux_loss


def aux_tokens(cfg):
    """The stub frontend's embeddings per prompt: ``enc_seq`` audio
    frames, or ``vision_tokens`` patches; 0 for a text-only config."""
    return cfg.enc_seq if cfg.enc_dec else cfg.vision_tokens


def _cross_source(params, cfg, aux, impl):
    """What cross attention reads, and the encoder's aux loss: the
    encoder's output over ``aux`` (encoder-decoder), else ``aux`` itself
    (the vision embeddings, or None for a decoder-only config)."""
    if aux_tokens(cfg) and aux is None:
        raise ValueError(f"{cfg.name} reads stub frontend embeddings: pass "
                         f"aux=(batch, {aux_tokens(cfg)}, d_model)")
    if cfg.enc_dec:
        return encode(params, cfg, aux, impl=impl)
    return aux, 0.0


def forward(params, cfg, tokens, *, aux=None, impl="auto"):
    """tokens: (B, S) integer; aux: (B, T, d) stub embeddings (audio
    frames or vision patches). Returns (logits (B, S, V) f32,
    aux_loss)."""
    cross_src, enc_loss = _cross_source(params, cfg, aux, impl)
    x = embed_tokens(params, cfg, tokens)
    x, aux_loss = _apply_groups(params, cfg, groups_of(cfg), x,
                                {"causal": True, "aux": cross_src,
                                 "impl": impl})
    return unembed(params, cfg, x), enc_loss + aux_loss


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def init_caches(cfg, batch, max_len, dtype=None, device=None):
    """Stacked (repeat-leading) empty caches for every decoder group
    (``None`` for an encoder group): zeros, and ``kpos = -1`` for empty
    slots. On the card unless ``device`` says otherwise
    (``device="cpu"``)."""
    dtype = dtype or common.dtype_of(cfg)
    device = resolve_device(device)
    caches = []
    for _, pattern, repeat, is_enc in group_infos(cfg):
        if is_enc:
            caches.append(None)
            continue
        unit = tuple(blocks.block_cache_init(cfg, kind, batch, max_len, dtype,
                                             device) for kind in pattern)
        caches.append(tree_map(
            lambda t: t[None].expand(repeat, *t.shape).clone(), unit))
    return tuple(caches)


# ---------------------------------------------------------------------------
# Prefill (fills caches) and decode
# ---------------------------------------------------------------------------

def prefill(params, cfg, tokens, *, aux=None, max_len=None,
            last_only=False, impl="auto"):
    """Full forward that also returns filled decode caches.

    Returns (logits, caches): logits over all S positions, or only the
    final position with ``last_only`` (what serving needs). ``aux``: the
    stub frontend embeddings, encoded first for an encoder-decoder.
    ``max_len`` sizes the KV caches (defaults to S; pass S + generation
    budget for serving). ``impl`` reaches the attention and SSD kernel
    ops.
    """
    B, S = tokens.shape
    max_len = max_len or S
    cross_src, _ = _cross_source(params, cfg, aux, impl)
    x = embed_tokens(params, cfg, tokens)
    ctx = {"causal": True, "aux": cross_src, "max_len": max_len,
           "impl": impl}
    caches = []
    for gi, pattern, repeat, is_enc in group_infos(cfg):
        if is_enc:
            caches.append(None)
            continue
        layers = []
        for r in range(repeat):
            ucaches = []
            for kind, bp in zip(pattern, _layer(params["groups"][gi], r)):
                x, c = blocks.block_prefill(bp, cfg, kind, x, ctx)
                ucaches.append(c)
            layers.append(tuple(ucaches))
        caches.append(tree_stack(layers))
    if last_only:
        x = x[:, -1]
    return unembed(params, cfg, x), tuple(caches)


def serve_step(params, cfg, caches, tokens, pos):
    """One decode step. tokens: (B,) integer; pos: the new token's
    position. Returns (logits (B, V), caches), the caches updated in
    place."""
    x = embed_tokens(params, cfg, tokens)
    ctx = {}
    for gi, pattern, repeat in groups_of(cfg):
        for r in range(repeat):
            unit_p = _layer(params["groups"][gi], r)
            unit_c = _layer(caches[gi], r)
            for kind, bp, c in zip(pattern, unit_p, unit_c):
                x, _ = blocks.block_decode(bp, cfg, kind, c, x, pos, ctx)
    return unembed(params, cfg, x), caches
