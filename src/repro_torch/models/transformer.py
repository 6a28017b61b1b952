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

Each entry point takes ``dist`` (``mlp.Dist``, default ``NO_DIST``) as
the reference's does: enabled, its inputs are this rank's batch shard
and its params the blocks the rank holds (``shard_params``: each leaf
the block of the reference's ``param_specs`` for the rank, as
``held_specs`` gives it; ``gather_params`` puts the tree back
together). The rank computes on them one unit at a time
(``for_use``): attention on its own heads and the dense MLP on its own
ff slice where "model" splits them (tensor-parallel, the output summed
over "model"), the MoE expert-parallel, every other split leaf
(d_model over "data", the SSM's and RG-LRU's leaves) gathered whole
where it is read. ``embed`` and ``lm_head`` stay vocab-parallel
(``vocab_parallel``): each rank looks up the tokens of its V/m rows and
the lookups are summed over "model", and the logits a rank computes,
and the entry points return, are its block of the vocabulary
(``whole_logits`` and ``greedy`` make them whole or pick from them).
Decode caches are the rank's blocks of ``sharding.cache_specs_tree``
(``prefill(seq_axis_model=)``): kv heads or, at batch 1, the sequence
over "model", an SSM state's hd or H.

Encoder-decoder (``cfg.enc_dec``): the leading groups that fall inside
``cfg.enc_layers`` form the bidirectional encoder over the stub audio
embeddings ``aux`` (``encode``); the rest form the decoder, whose
``xdec`` blocks cross-attend to the encoder's output. Vision
(``cfg.vision_tokens``): ``cross_attn`` blocks attend to the stub patch
embeddings passed as ``aux``. Encoder groups hold ``None`` for caches.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import sharding
from repro_torch.convert import tree_leaves, tree_map, tree_stack
from repro_torch.device import resolve_device
from repro_torch.models import blocks, common
from repro_torch.models.attention import AttnOpts
from repro_torch.models.mlp import NO_DIST, model_split, moe_specs


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
# What each rank holds under a Dist, and what it computes on
# ---------------------------------------------------------------------------

# the first keys of a params tree's paths (a tree whose paths start
# otherwise is a unit's views, as ``_layer`` gives them: no ``R`` axis)
_TOP_KEYS = ("embed", "lm_head", "final_norm", "enc_norm", "groups")
_EXPERT_LEAVES = ("wi", "wg", "wo")


def _is_expert(cfg, path):
    """A MoE's expert weight (its shared experts' are not)."""
    return (cfg.moe is not None and path[-1] in _EXPERT_LEAVES
            and len(path) >= 2 and path[-2] == "mlp")


@functools.lru_cache(maxsize=None)
def whole_shapes(cfg):
    """{path: shape} of ``cfg``'s whole params: a top-level leaf's by its
    path, a group leaf's by its path within a block (no ``R`` axis), from
    an ``init`` on fake tensors (no storage), outside any dispatch mode
    the caller runs under (the dry run's analysis sees none of it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes(), FakeTensorMode():
        params = init(torch.Generator().manual_seed(0), cfg)
    table = {}

    def note(path, t):
        if path[0] == "groups":
            key, shape = path[3:], tuple(t.shape[1:])
            if table.setdefault(key, shape) != shape:
                raise ValueError(f"{cfg.name}: {'/'.join(key)} has two "
                                 f"shapes, {table[key]} and {shape}")
        else:
            table[path] = tuple(t.shape)

    sharding.map_with_path(note, params)
    return table


def _whole_shape(path, cfg):
    """The whole shape of the leaf at ``path`` (``held_specs``'s paths),
    whatever block of the rank's the caller holds; a stacked leaf's
    ``R`` axis, never split, as 1."""
    if path[0] == "groups":
        return (1,) + whole_shapes(cfg)[path[3:]]
    if path[0] in _TOP_KEYS:
        return whole_shapes(cfg)[path]
    return whole_shapes(cfg)[path[1:] if path[0].isdigit() else path]


def _spec_of(path, cfg, dist):
    """One leaf's spec as a rank of ``dist`` holds it: the reference's
    ``param_specs`` rule for its path and its whole shape
    (``sharding.leaf_spec``, or ``unit_spec`` for a unit's view); a MoE's
    expert weight checked against ``mlp.moe_specs``, which its
    expert-parallel body reads."""
    shape = _whole_shape(path, cfg)
    if path[0] in _TOP_KEYS:
        spec = sharding.leaf_spec(path, shape, dist.mesh)
    else:
        spec = sharding.unit_spec(path, shape, dist.mesh)
    if _is_expert(cfg, path) or (cfg.moe is not None and "shared" in path):
        want = moe_specs({"shared": None}, dist)
        if "shared" in path:
            # the shared experts' d_model is gathered before the body
            want = want["shared"][path[-1]]
            got = _drop(spec, lambda a: a != dist.model_axis)
        else:
            want, got = want[path[-1]], spec
        if tuple(got[-len(want):]) != tuple(want):
            raise ValueError(
                f"{'/'.join(path)} {tuple(shape)}: the rules give "
                f"{spec}, the expert-parallel MoE reads {want}")
    return tuple(spec)


def _drop(spec, gone):
    """``spec`` without the axes for which ``gone(axis)`` holds."""
    out = []
    for e in spec:
        left = () if e is None else tuple(
            a for a in sharding._names(e) if not gone(a))
        out.append(None if not left else left[0] if len(left) == 1
                   else left)
    return tuple(out)


def held_specs(tree, cfg, dist):
    """The spec of each leaf of ``tree`` (the params, Adam's ``m`` or
    ``v``, a unit's views, or a dict of top-level leaves), in
    ``tree_leaves`` order, as a rank holds it under ``dist``: the block
    that the reference's ``param_specs`` gives its device (attention
    heads and the dense MLP's ff on "model", d_model on "data", ``embed``
    and ``lm_head`` vocab-parallel, the experts on "model" and their
    d_model on "data"; an axis that does not divide its dim dropped);
    every leaf whole under ``NO_DIST``."""
    out = []

    def spec_of(path, t):
        if not dist.enabled:
            out.append((None,) * len(t.shape))
        else:
            out.append(_spec_of(path, cfg, dist))

    sharding.map_with_path(spec_of, tree)
    return out


def tensor_parallel_heads(cfg, dist):
    """Whether attention runs tensor-parallel under ``dist``: each rank
    on its ``H / m`` query heads, its ``wo`` rows summed over the model
    axis. Only where "model" splits work (``model_split``) and the
    heads; else every rank runs every head on the gathered weights."""
    return model_split(dist) and cfg.n_heads % dist.model_size() == 0


def vocab_parallel(cfg, dist):
    """Whether ``embed`` and ``lm_head`` stay split over "model" where
    they are used (the rules split the padded vocabulary, a multiple of
    128, wherever "model" divides it): the lookup's and the logits'
    work on the rank's V/m rows."""
    return model_split(dist) and cfg.padded_vocab % dist.model_size() == 0


def vocab_block(cfg, dist, n_rows):
    """(mesh, model axis, the global index of the rank's first row) of a
    vocab-parallel table block of ``n_rows`` rows, or None where the
    table is used whole."""
    if not vocab_parallel(cfg, dist):
        return None
    return (dist.mesh, dist.model_axis,
            sharding.axis_index(dist.mesh, dist.model_axis) * n_rows)


def _kept(path, cfg, dist):
    """The axes of a held leaf's spec that stay split while a rank
    computes on it: "model" on the heads of attention's leaves and on
    the ff of the dense MLP's (tensor-parallel), on the MoE's shared
    experts' ff; every axis of an expert weight (the MoE body gathers
    its d_model itself); "model" on the vocab of ``embed`` and
    ``lm_head`` (``vocab_parallel``); none of any other leaf."""
    if _is_expert(cfg, path):
        return None
    if dist.model_axis in dist.batch_axes:
        return ()
    if path[0] in ("embed", "lm_head"):
        return (dist.model_axis,) if vocab_parallel(cfg, dist) else ()
    if "attn" in path or "xattn" in path:
        return (dist.model_axis,) if tensor_parallel_heads(cfg, dist) \
            else ()
    if "mlp" in path:
        return (dist.model_axis,)
    return ()


def for_use(tree, cfg, dist):
    """``tree`` (leaves a rank holds: a unit's views, or a dict of
    top-level leaves such as ``{"embed": ...}``) as the rank computes on
    it: each leaf gathered (``sharding.gather_for_use``) over every axis
    of its held spec but those ``_kept`` keeps split. Called one unit
    at a time inside the layer loops, so at most one unit's weights are
    whole at once. The tree itself under ``NO_DIST``."""
    if not dist.enabled:
        return tree

    def one(path, t):
        spec = _spec_of(path, cfg, dist)
        kept = _kept(path, cfg, dist)
        if kept is None:
            return t
        return sharding.gather_for_use(t, _drop(spec, lambda a: a in kept),
                                       dist.mesh, dist.batch_axes)

    return sharding.map_with_path(one, tree)


def shard_params(tree, cfg, dist):
    """This rank's blocks of a whole tree (params or Adam state): copies
    of the blocks of every split leaf, the rest as it is."""
    return sharding.shard_tree(tree, held_specs(tree, cfg, dist), dist.mesh)


def gather_params(tree, cfg, dist):
    """The whole tree from every rank's shards (``shard_params``'s
    inverse; every rank calls it)."""
    return sharding.gather_tree(tree, held_specs(tree, cfg, dist),
                                dist.mesh)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def top_leaf(params, key, cfg, dist=NO_DIST):
    """The top-level leaf ``params[key]`` as a rank computes on it
    (``for_use``): under a ``Dist``, ``embed`` and ``lm_head`` gathered
    over d_model, their vocab the rank's block where ``vocab_parallel``
    (else whole)."""
    return for_use({key: params[key]}, cfg, dist)[key]


def embed_tokens(params, cfg, tokens, dist=NO_DIST):
    """The embedding rows of ``tokens``. ``F.embedding`` rather than an
    index: its backward has a deterministic CUDA kernel, which the LM
    trainers' bit-exact gates run under. Vocab-parallel, each rank
    looks up the tokens that fall in its rows, zero for the rest, and
    the ranks' rows are summed over "model" (``psum``, whose transpose
    hands each rank the whole cotangent: its block's grad is its
    rows')."""
    table = top_leaf(params, "embed", cfg, dist)
    vb = vocab_block(cfg, dist, table.shape[0])
    if vb is None:
        return F.embedding(tokens.long(), table)
    mesh, axis, off = vb
    local = tokens.long() - off
    inside = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(inside, local, 0), table)
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return sharding.psum(rows, mesh, axis)


def unembed(params, cfg, x, dist=NO_DIST):
    """Logits (..., V) f32 of the features ``x``: ``final_norm``, the
    tied table or ``lm_head``, the softcap, pad rows masked. Under
    ``vocab_parallel`` the rank's block (..., V/m) of them: ``x``
    enters through ``pvary`` (its cotangent summed over the blocks),
    the pad mask at the block's global indices."""
    x = common.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = top_leaf(params, "embed", cfg, dist).T
    else:
        w = top_leaf(params, "lm_head", cfg, dist)
    vb = vocab_block(cfg, dist, w.shape[1])
    off = 0
    if vb is not None:
        mesh, axis, off = vb
        x = sharding.pvary(x, mesh, axis)
    logits = x @ w
    logits = common.softcap(logits.float(), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:       # mask pad-row logits
        pad_mask = (off + torch.arange(w.shape[1], device=x.device)
                    >= cfg.vocab)
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


def _vocab_split(logits, cfg, dist):
    """Whether ``logits`` are a rank's vocab block."""
    return (vocab_parallel(cfg, dist)
            and logits.shape[-1] != cfg.padded_vocab)


def whole_logits(logits, cfg, dist=NO_DIST):
    """Logits over the whole vocabulary from each rank's block of them
    (what the entry points return under ``vocab_parallel``), gathered
    over "model"; ``logits`` themselves where they are whole."""
    if not _vocab_split(logits, cfg, dist):
        return logits
    return sharding.all_gather(logits, dist.mesh, dist.model_axis,
                               logits.dim() - 1)


def first_max(vals, idx):
    """Of the candidates ``vals`` (..., n) at global indices ``idx``
    (..., n), the index of the largest value, the lowest index among
    equal ones: ``torch.argmax``'s choice over the whole."""
    best = vals.amax(-1, keepdim=True)
    idx = torch.where(vals == best, idx, torch.iinfo(idx.dtype).max)
    return idx.amin(-1)


def greedy(logits, cfg, dist=NO_DIST):
    """The greedy tokens (int32) of logits, whole or the rank's vocab
    block: ``torch.argmax`` over the last dim, or each block's largest
    value at its first global index, gathered over "model", and the
    largest of those (``first_max``). Every rank of "model" gets the
    same tokens."""
    if not _vocab_split(logits, cfg, dist):
        return logits.argmax(-1).to(torch.int32)
    vals, idx = logits.max(-1)
    idx = idx + sharding.axis_index(dist.mesh, dist.model_axis) \
        * logits.shape[-1]
    pair = torch.stack([vals.double(), idx.double()], -1)[..., None, :]
    pair = sharding.all_gather(pair, dist.mesh, dist.model_axis,
                               pair.dim() - 2)
    return first_max(pair[..., 0], pair[..., 1].long()).to(torch.int32)


def unit_of(params, cfg, gi, r, dist=NO_DIST):
    """Unit ``r`` of group ``gi`` as a rank computes on it: its views
    (``_layer``), each leaf gathered for use (``for_use``)."""
    return for_use(_layer(params["groups"][gi], r), cfg, dist)


def _unit_apply(unit, cfg, pattern, x, ctx):
    """x through one unit's blocks (the unit's held views, gathered
    here): (x, the unit's summed router aux losses)."""
    aux_loss = torch.zeros((), device=x.device)
    for kind, bp in zip(pattern, for_use(unit, cfg, ctx["dist"])):
        x, a = blocks.block_apply(bp, cfg, kind, x, ctx)
        aux_loss = aux_loss + a
    return x, aux_loss


def _apply_groups(params, cfg, groups, x, ctx):
    """x through every unit of ``groups`` ((index, pattern, repeat)
    triples): (x, the summed router aux losses). Under a ``Dist`` with
    grad enabled each unit is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's remat), so only one
    unit's gathered weights are alive at a time there too."""
    aux_loss = torch.zeros((), device=x.device)
    remat = ctx["dist"].enabled and torch.is_grad_enabled()
    for gi, pattern, repeat in groups:
        for r in range(repeat):
            unit = _layer(params["groups"][gi], r)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    _unit_apply, unit, cfg, pattern, x, ctx,
                    use_reentrant=False)
            else:
                x, a = _unit_apply(unit, cfg, pattern, x, ctx)
            aux_loss = aux_loss + a
    return x, aux_loss


def encode(params, cfg, aux_embed, *, dist=NO_DIST, impl="auto",
           attn_opts=AttnOpts()):
    """Run the encoder groups bidirectionally over the stub frame
    embeddings (B, T, d). Returns (the normed encoder output, aux_loss).
    ``attn_opts``: the chunked attention's options (``causal_skip`` has
    no causal attention to act on here)."""
    x, aux_loss = _apply_groups(params, cfg, groups_of(cfg, encoder=True),
                                aux_embed, {"causal": False, "impl": impl,
                                            "dist": dist,
                                            "attn_opts": attn_opts})
    return common.rms_norm(x, params["enc_norm"], cfg.norm_eps), aux_loss


def aux_tokens(cfg):
    """The stub frontend's embeddings per prompt: ``enc_seq`` audio
    frames, or ``vision_tokens`` patches; 0 for a text-only config."""
    return cfg.enc_seq if cfg.enc_dec else cfg.vision_tokens


def _cross_source(params, cfg, aux, impl, dist, attn_opts=AttnOpts()):
    """What cross attention reads, and the encoder's aux loss: the
    encoder's output over ``aux`` (encoder-decoder), else ``aux`` itself
    (the vision embeddings, or None for a decoder-only config)."""
    if aux_tokens(cfg) and aux is None:
        raise ValueError(f"{cfg.name} reads stub frontend embeddings: pass "
                         f"aux=(batch, {aux_tokens(cfg)}, d_model)")
    if cfg.enc_dec:
        return encode(params, cfg, aux, dist=dist, impl=impl,
                      attn_opts=attn_opts)
    return aux, 0.0


def forward(params, cfg, tokens, *, aux=None, dist=NO_DIST, impl="auto",
            attn_impl=None, attn_opts=AttnOpts()):
    """tokens: (B, S) integer; aux: (B, T, d) stub embeddings (audio
    frames or vision patches). Returns (logits (B, S, V) f32,
    aux_loss). With ``dist`` enabled, tokens and aux are this rank's
    batch shard, the MoE runs expert-parallel (``mlp.Dist``) and the
    logits are the rank's vocab block (``vocab_parallel``).
    ``attn_impl`` (default ``impl``) routes the decoder's attention,
    ``impl`` the rest. ``attn_opts`` (``attention.AttnOpts``): the
    reference's §Perf options of its chunked attention, for every call
    that runs it."""
    cross_src, enc_loss = _cross_source(params, cfg, aux, impl, dist,
                                        attn_opts)
    x = embed_tokens(params, cfg, tokens, dist)
    x, aux_loss = _apply_groups(params, cfg, groups_of(cfg), x,
                                {"causal": True, "aux": cross_src,
                                 "impl": impl,
                                 "attn_impl": (impl if attn_impl is None
                                               else attn_impl),
                                 "dist": dist, "attn_opts": attn_opts})
    return unembed(params, cfg, x, dist), enc_loss + aux_loss


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


def cache_specs(cfg, batch, max_len, dtype=None):
    """``init_caches`` on the ``meta`` device: the caches' shapes and
    dtypes without storage (the reference's ShapeDtypeStruct tree), for
    the dry run."""
    return init_caches(cfg, batch, max_len, dtype, device="meta")


# ---------------------------------------------------------------------------
# Prefill (fills caches) and decode
# ---------------------------------------------------------------------------

def prefill(params, cfg, tokens, *, aux=None, dist=NO_DIST, max_len=None,
            last_only=False, impl="auto", seq_axis_model=None,
            attn_opts=AttnOpts()):
    """Full forward that also returns filled decode caches.

    Returns (logits, caches): logits over all S positions, or only the
    final position with ``last_only`` (what serving needs). ``aux``: the
    stub frontend embeddings, encoded first for an encoder-decoder.
    ``max_len`` sizes the KV caches (defaults to S; pass S + generation
    budget for serving). ``impl`` reaches the attention and SSD kernel
    ops, ``attn_opts`` the chunked attention (``forward``'s).
    ``dist``: as ``forward``'s (tokens, aux and the caches are this
    rank's batch shard; the logits its vocab block); each cache the
    rank's block of ``sharding.cache_specs_tree(seq_axis_model=)``
    (``blocks.cache_block``): ``seq_axis_model`` says whether the
    sequence, and an SSM state's H, split over "model" rather than the
    kv heads and an SSM state's hd, as the reference's specs do at a
    whole batch of 1; by default where the rank holds one row.
    """
    B, S = tokens.shape
    max_len = max_len or S
    if seq_axis_model is None:
        seq_axis_model = B == 1
    cross_src, _ = _cross_source(params, cfg, aux, impl, dist, attn_opts)
    x = embed_tokens(params, cfg, tokens, dist)
    ctx = {"causal": True, "aux": cross_src, "max_len": max_len,
           "impl": impl, "dist": dist, "seq_axis_model": seq_axis_model,
           "attn_opts": attn_opts}
    caches = []
    for gi, pattern, repeat, is_enc in group_infos(cfg):
        if is_enc:
            caches.append(None)
            continue
        layers = []
        for r in range(repeat):
            ucaches = []
            for kind, bp in zip(pattern, unit_of(params, cfg, gi, r, dist)):
                x, c = blocks.block_prefill(bp, cfg, kind, x, ctx)
                ucaches.append(c)
            layers.append(tuple(ucaches))
        caches.append(tree_stack(layers))
    if last_only:
        x = x[:, -1]
    return unembed(params, cfg, x, dist), tuple(caches)


def serve_step(params, cfg, caches, tokens, pos, *, dist=NO_DIST):
    """One decode step. tokens: (B,) integer; pos: the new token's
    position. Returns (logits (B, V), caches), the caches updated in
    place. ``dist``: as ``forward``'s (tokens this rank's batch shard,
    the caches its blocks as ``prefill`` leaves them, the logits its
    vocab block)."""
    x = embed_tokens(params, cfg, tokens, dist)
    ctx = {"dist": dist}
    for gi, pattern, repeat in groups_of(cfg):
        for r in range(repeat):
            unit_p = unit_of(params, cfg, gi, r, dist)
            unit_c = _layer(caches[gi], r)
            for kind, bp, c in zip(pattern, unit_p, unit_c):
                x, _ = blocks.block_decode(bp, cfg, kind, c, x, pos, ctx)
    return unembed(params, cfg, x, dist), caches
