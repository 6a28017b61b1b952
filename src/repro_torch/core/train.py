"""FF training of the LM configs, and the backpropagation baseline (the
port of ``repro.core.train``).

The joint FF step (``make_ff_train_step``) trains every block each step:

  * positive batch = real token sequences; negative batch = corrupted
    sequences (``core.ff``), concatenated on the batch axis so both FF
    passes share every matmul.
  * each block's loss is layer-local: the block input is detached, and
    the goodness of the block's residual update is pushed high for
    positives and low for negatives. No gradient crosses a block
    boundary; each block's grad and Adam update run before the next
    block's forward, as the reference's scan over stacked layers does.
  * the LM head is the paper's softmax classifier, trained with a local
    CE on detached features; with tied embeddings the table receives
    that CE grad through the unembed too.
  * the embedding is trained with its own local goodness loss (the FF
    "layer 1").

Goodness modes (``cfg.ff.goodness``): "sumsq" (paper Eq. 1 on the
block's residual update; needs negatives) and "perf_opt" (§4.4: a local
classifier loss, CE to the next token through the detached embedding
table; no negatives).

Routing: a forward that is differentiated runs with ``impl="ref"``, the
plain SSD, which autograd differentiates (its CUDA kernel has no backward
and refuses inputs that need one, ``kernels/guard.py``), and attention
with the step maker's ``impl`` (``REF``'s ``attn_impl``): on the card the
causal self-attention the backward kernel takes goes through the
kernels under autograd (``models.attention.kernel_attention``), every
other differentiated call through the reference's chunked route
(``models.attention.chunked_attention``), whose options ``attn_opts``
carries.
A forward that needs no gradient (AdaptiveNEG's, ``eval_ce``) runs under
``torch.no_grad()`` with the step maker's ``impl`` (default "auto": the
CUDA kernels on the card), the knob that lets a whole fit run the plain
route for comparison.

Stub frontend embeddings: an encoder-decoder config (``cfg.enc_dec``)
reads audio frames and a vision config (``cross_attn`` blocks) image
patches, each a ``batch["aux"]`` of shape (B, T, d_model) passed to
every trainer and to ``eval_ce(aux=)`` as the reference's
``core/train.py`` takes it (:109, :131-133, :145-147, :329-339, :352).
Nothing in either package computes them: the training CLI
(``launch.train``, as ``repro/launch/train.py:126-140``) draws them once
with ``launch.serve.frontend_embeddings`` and feeds the same tensor every
step. The joint FF step FF-trains the encoder's units first, over
``aux`` (doubled with the negatives), bidirectionally, then the decoder
cross-attends to ``rms_norm(encoder output, enc_norm)``; a vision config
cross-attends to ``aux`` itself (reference :215-237). The chapter
schedule (``core.pff_lm``) takes no stub embeddings, as the reference's
does not (``repro/core/pff_lm.py:46``, :61): it refuses these configs.

Random draws come from ``key_fn(seed)`` (default ``core.rng.TorchKey``),
folded by the step number as the reference folds its jax key; the tests
pass a jax-backed key to reproduce the reference's negatives. Params and
Adam state are updated in place (``optim.adam_update``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import optim, sharding
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import ff
from repro_torch.core.rng import TorchKey
from repro_torch.models import blocks, common, transformer
from repro_torch.models.attention import AttnOpts
from repro_torch.models.mlp import NO_DIST

AUX_WEIGHT = 0.01      # router load-balance weight (local per block)
CE_CHUNK = 512         # sequence chunk for vocab-logit computation
# ctx of a differentiated forward: the plain SSD, attention by the
# kernels' route rule (``models.attention.chunked_attention``); a step
# maker puts its own ``impl`` in ``attn_impl``
REF = {"causal": True, "impl": "ref", "attn_impl": "auto"}
ENC_REF = {"causal": False, "impl": "ref"}   # the encoder's, bidirectional


def unit_views(group, r):
    """Unit ``r`` of a stacked group: views, so an in-place update of a
    unit lands in the stacked leaves."""
    return tree_map(lambda a: a[r], group)


def trainable(tree):
    """Leaves that autograd tracks and that share storage with ``tree``'s
    (read before ``tree`` is updated in place)."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def grads_of(loss, tree):
    """d loss / d every leaf of ``tree`` (zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives)."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, gs)]


def adam_leaves(params, grads, m, v, *, lr, step):
    """``optim.adam_update`` on the trees ``params``/``m``/``v`` (updated
    in place) with ``grads`` given as a leaf list in their order."""
    optim.adam_update(tree_leaves(params), grads,
                      {"m": tree_leaves(m), "v": tree_leaves(v)},
                      lr=lr, step=step)


# ---------------------------------------------------------------------------
# Local losses
# ---------------------------------------------------------------------------

def _block_ff_loss(delta, is_pos, theta):
    """delta: (B2, S, d) the block's residual update."""
    g = ff.mean_goodness(delta)                       # (B2, S)
    return ff.ff_loss_masked(g, is_pos, theta), g


def vocab_ce(logits, labels, vocab=None):
    """Per-position CE of ``logits`` (..., V) f32 against ``labels``
    (...). ``vocab``: None where the logits are whole, else (mesh, axis,
    the global index of the block's first entry) of the rank's vocab
    block of them (``transformer.vocab_block``): the log-sum-exp
    combined over the axis (``sharding.logsumexp``), the label's logit
    the owner's pick summed over it (``psum``; every rank of the axis
    computes the CE alike, and each one's cotangent reaches its block)."""
    labels = labels.long()
    if vocab is None:
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, labels[..., None])[..., 0]
    mesh, axis, off = vocab
    n = logits.shape[-1]
    local = labels - off
    inside = (local >= 0) & (local < n)
    pick = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    pick = sharding.psum(torch.where(inside, pick, torch.zeros(
        (), dtype=pick.dtype, device=pick.device)), mesh, axis)
    return sharding.logsumexp(logits, mesh, axis) - pick


def _ce_chunk(hc, lc, mc, w, softcap, vocab):
    logits = torch.einsum("bsd,vd->bsv", hc.float(), w.float())
    logits = common.softcap(logits, softcap)
    return torch.sum(vocab_ce(logits, lc, vocab) * mc)


def _ce_chunked(h, w_unembed, labels, mask, softcap=0.0, vocab=None):
    """Cross-entropy without holding (B, S, V) logits for the backward.

    One sequence chunk at a time; each chunk's logits are recomputed in
    the backward (``torch.utils.checkpoint``), so the backward never
    holds more than one chunk's logits either.
    h: (B, S, d); w_unembed: (V, d); labels/mask: (B, S).
    ``vocab``: ``vocab_ce``'s, where ``w_unembed`` is the rank's vocab
    block (V/m, d): ``h`` enters through ``pvary`` (its cotangent summed
    over the blocks), and each chunk's recompute issues its forward's
    collectives again, the same on every rank of the axis.
    Returns summed CE (summed mask weight is the caller's).
    """
    B, S, d = h.shape
    if tuple(labels.shape) != (B, S):
        # the reference's chunk reshape fails on such inputs too (perf_opt
        # scores an encoder's frames against the token labels)
        raise ValueError(f"labels {tuple(labels.shape)} do not match the "
                         f"features' (batch, positions) {(B, S)}")
    if vocab is not None:
        h = sharding.pvary(h, vocab[0], vocab[1])
    c = min(CE_CHUNK, S)
    labels = labels.long()
    if S % c:
        pad = c - S % c
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
        S += pad
    total = torch.zeros((), device=h.device)
    for i in range(0, S, c):
        args = (h[:, i:i + c], labels[:, i:i + c], mask[:, i:i + c],
                w_unembed, softcap, vocab)
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                _ce_chunk, *args, use_reentrant=False)
        else:
            part = _ce_chunk(*args)
        total = total + part
    return total


def _local_ce(h, embed_sg, labels, mask, count=None, vocab=None):
    """Local classifier loss via the (detached) embedding table, or the
    rank's vocab block of it (``vocab``, as ``_ce_chunked``'s): the CE
    summed over ``mask``, over ``count`` (default the mask's sum; under
    a ``Dist`` the whole batch's)."""
    z = common.rms_normalize(h)
    total = _ce_chunked(z, embed_sg, labels, mask, vocab=vocab)
    count = torch.sum(mask) if count is None else count
    return total / torch.clamp(count, min=1.0)


def head_ce(x, hp, cfg, labels, count=None, dist=NO_DIST):
    """The softmax head's CE on features ``x`` (detached by the caller):
    ``final_norm``, then the tied table or ``lm_head`` as the softmax
    layer (pad rows unmasked, as the reference has them), the rank's
    vocab block of it under ``dist`` where ``transformer.vocab_parallel``
    (``hp`` as ``transformer.for_use`` gives it); summed over ``count``
    positions (default ``labels``'s; under a ``Dist`` the whole
    batch's)."""
    h = common.rms_norm(x, hp["final_norm"], cfg.norm_eps)
    w = hp["embed"] if cfg.tie_embeddings else hp["lm_head"].T
    ones = torch.ones(labels.shape, device=x.device)
    total = _ce_chunked(h, w, labels, ones, softcap=cfg.logit_softcap,
                        vocab=transformer.vocab_block(cfg, dist, w.shape[0]))
    return total / (labels.numel() if count is None else count)


# ---------------------------------------------------------------------------
# One rank's part of a step under a Dist
# ---------------------------------------------------------------------------

class RankPart:
    """What a step under ``dist`` does per rank, where the reference's
    step is one GSPMD program whose activations ``constrain_batch`` pins
    to the batch axes: the rank's contiguous block of rows (``rows``;
    ``stacked`` of a stack of the batch), the grads of the leaves it
    holds summed over the batch axes they are replicated over
    (``grads``), and scalars summed over the batch axes in rank order
    (``total``). Each a no-op under ``NO_DIST``."""

    def __init__(self, cfg, dist):
        self.cfg, self.dist = cfg, dist
        self.on = dist.enabled
        self.n = (sharding.axes_size(dist.mesh, dist.batch_axes)
                  if self.on else 1)
        self.index = (sharding.axes_index(dist.mesh, dist.batch_axes)
                      if self.on else 0)

    def rows(self, t):
        """This rank's block of ``t``'s leading (batch) dim."""
        if not self.on or t is None:
            return t
        return sharding.block_of(t, self.dist.mesh, self.dist.batch_axes)

    def gather(self, t):
        """``rows``'s inverse: the whole batch from every rank's block."""
        if not self.on:
            return t
        return sharding.gather_blocks(t, self.dist.mesh,
                                      self.dist.batch_axes)

    def stacked(self, t, copies):
        """This rank's block of ``copies`` copies of the batch stacked on
        the rows, from ``t``, its block of the batch: rows moved point to
        point from the ranks that hold them (``sharding.stacked_block``),
        never gathered whole."""
        if t is None or copies == 1:
            return t
        if not self.on:
            return torch.cat([t] * copies, dim=0)
        return sharding.stacked_block(t, self.dist.mesh,
                                      self.dist.batch_axes, copies)

    def grads(self, grads, tree):
        """``grads`` (of ``tree``'s leaves, in order) summed over the batch
        axes that the leaves are replicated over. A leaf split over a
        batch axis has its grad summed over it already, by the transpose
        of the gather that made it whole (``sharding.gather_for_use``), as
        an expert weight's comes out of the MoE's backward summed over
        the fsdp axis: ``sum_grads`` skips the axes a spec names."""
        if not self.on:
            return grads
        return sharding.sum_grads(
            grads, transformer.held_specs(tree, self.cfg, self.dist),
            self.dist.mesh, self.dist.batch_axes)

    def total(self, x):
        """The sum of the 0-d or 1-d ``x`` over the batch axes' ranks."""
        if not self.on:
            return x
        return sharding.sum_in_rank_order(x, self.dist.mesh,
                                          self.dist.batch_axes)


# ---------------------------------------------------------------------------
# FF train step (joint: every block each step)
# ---------------------------------------------------------------------------

def make_ff_train_step(cfg, *, dist=NO_DIST, lr=1e-3, seed=0,
                       key_fn=TorchKey, impl="auto", attn_opts=AttnOpts()):
    """Returns step_fn(params, opt_state, batch, step) ->
    (params, opt_state, metrics), params and state updated in place.

    batch: {"tokens": (B, S+1) integer tensor, optional "aux": (B, T, d)
    stub frontend embeddings}. opt_state: ``optim.adam_init(params)``.
    ``impl`` routes the no-grad forward of AdaptiveNEG
    (``cfg.ff.neg_mode == "adaptive"``). ``attn_opts``
    (``attention.AttnOpts``) reaches every forward's chunked attention,
    that one's too.

    Under an enabled ``dist`` (``mlp.Dist``) ``batch`` is the rank's
    block of the batch's rows over ``dist.batch_axes`` (as ``prefill``
    and ``serve_step`` take theirs), and params and opt_state the trees
    it holds (``transformer.shard_params``: each leaf and its Adam state
    the rank's block of the reference's rules), each unit's leaves
    gathered for use inside its loop (``transformer.for_use``), so that
    a grad reaches the rank's block alone. The token ids are gathered
    (a few MB) and every rank draws the same negatives over the whole
    batch (AdaptiveNEG's forward runs on the rank's rows, its logits
    gathered whole before the draw), then keeps its block of the
    stacked [pos; neg] rows, in the reference's row layout (the MoE's
    capacity drops depend on which tokens share a rank); its rows of the
    stacked aux come point to point from the ranks that hold them
    (``RankPart.stacked``). Each loss term is its rows' part of the
    whole batch's (their sum over the global count), a replicated leaf's
    grads are summed over the batch axes before its Adam step, and the
    metrics are the whole batch's, summed in rank order.
    """
    perf_opt = cfg.ff.goodness == "perf_opt"
    theta = cfg.ff.theta
    n_units = sum(r for _, _, r, _ in transformer.group_infos(cfg))
    part = RankPart(cfg, dist)

    def step_fn(params, opt_state, batch, step):
        own = batch["tokens"]                # the rank's rows
        tokens = part.gather(own)            # every rank's token ids
        B, S1 = tokens.shape
        S = S1 - 1
        dev = tokens.device
        pos_tok, labels = tokens[:, :-1], tokens[:, 1:]
        aux_in = batch.get("aux")            # the rank's rows
        key = key_fn(seed).fold_in(step)
        metrics = {}

        if perf_opt:
            x_tok = pos_tok
            is_pos = torch.ones((B,), device=dev)
            lab_all = labels
        else:
            if cfg.ff.neg_mode == "adaptive":
                # self-generated negatives from the current model (the
                # AdaptiveNEG cost the paper reports), no grad: kernels
                with torch.no_grad():
                    logits0, _ = transformer.forward(
                        params, cfg, own[:, :-1], aux=aux_in, dist=dist,
                        impl=impl, attn_opts=attn_opts)
                    logits0 = part.gather(transformer.whole_logits(
                        logits0, cfg, dist))
                neg_tok = ff.adaptive_corrupt_tokens(key, pos_tok, logits0)
                del logits0
            else:
                nkey = key_fn(seed + 1) if cfg.ff.neg_mode == "fixed" \
                    else key
                neg_tok = ff.corrupt_tokens(nkey, pos_tok, cfg.vocab)
            x_tok = torch.cat([pos_tok, neg_tok], dim=0)
            is_pos = torch.cat([torch.ones((B,), device=dev),
                                torch.zeros((B,), device=dev)])
            lab_all = torch.cat([labels, labels], dim=0)
        # the rank's rows of the stacked aux, as of the tokens below
        aux_in = part.stacked(aux_in, x_tok.shape[0] // B)
        # the whole batch's counts, then this rank's rows of it
        npos = torch.clamp(is_pos.sum(), min=1.0)
        nneg = torch.clamp((1 - is_pos).sum(), min=1.0)
        ce_count = is_pos.sum() * S
        n_rows = x_tok.shape[0]
        x_tok, is_pos, lab_all = (part.rows(t)
                                  for t in (x_tok, is_pos, lab_all))
        share = x_tok.shape[0] / n_rows      # of each mean over the rows
        # the rank's positive rows lead its block (the positives are the
        # whole batch's first B rows)
        n_pos_here = max(0, min(x_tok.shape[0],
                                B - part.index * x_tok.shape[0]))

        # the table where the local CE reads it (perf_opt): whole, or the
        # rank's vocab block
        embed_sg = (transformer.top_leaf(params, "embed", cfg, dist)
                    .detach() if perf_opt else None)
        vocab = (transformer.vocab_block(cfg, dist, embed_sg.shape[0])
                 if perf_opt else None)
        ce_mask = is_pos[:, None] * torch.ones((1, S), device=dev)

        # ---- embedding: FF layer 1 (local loss); grad now, update later
        # (tied archs add the head-CE grad below)
        with torch.enable_grad():
            emb = params["embed"].detach().requires_grad_()
            h = transformer.embed_tokens({"embed": emb}, cfg, x_tok, dist)
            if perf_opt:
                emb_l = _local_ce(h, embed_sg, lab_all, ce_mask, ce_count,
                                  vocab)
            else:
                g = ff.mean_goodness(common.rms_normalize(h))
                emb_l = ff.ff_loss_masked(g, is_pos, theta) * share
            (emb_g,) = torch.autograd.grad(emb_l, [emb])
        emb_l = emb_l.detach()
        x = h.detach()

        # ---- the stacks: each unit's grad and Adam update, in order ------
        ff_losses = []
        # each group's router aux, which every batch rank adds whole
        aux_parts = []
        g_sums = [torch.zeros((), device=dev), torch.zeros((), device=dev)]

        def train_units(groups, x, ctx):
            ctx = {**ctx, "dist": dist, "attn_opts": attn_opts}
            for gi, pattern, repeat in groups:
                group_loss = torch.zeros((), device=dev)
                group_aux = torch.zeros((), device=dev)
                for r in range(repeat):
                    unit = unit_views(params["groups"][gi], r)
                    up = trainable(unit)
                    with torch.enable_grad():
                        h = x
                        total = torch.zeros((), device=dev)
                        gp = torch.zeros((), device=dev)
                        gn = torch.zeros((), device=dev)
                        for kind, bp in zip(pattern, transformer.for_use(
                                up, cfg, dist)):
                            h_sg = h.detach()
                            y, moe_aux = blocks.block_apply(bp, cfg, kind,
                                                            h_sg, ctx)
                            if perf_opt:
                                loss = _local_ce(y, embed_sg, lab_all,
                                                 ce_mask, ce_count, vocab)
                            else:
                                loss, g = _block_ff_loss(y - h_sg, is_pos,
                                                         theta)
                                loss = loss * share
                                gm = g.detach().mean(1)
                                gp = gp + (gm * is_pos).sum() / npos
                                gn = gn + (gm * (1 - is_pos)).sum() / nneg
                            total = total + loss + AUX_WEIGHT * moe_aux
                            group_aux = group_aux + AUX_WEIGHT * \
                                moe_aux.detach()
                            h = y
                        grads = part.grads(grads_of(total, up), unit)
                    adam_leaves(unit, grads,
                                unit_views(opt_state["m"]["groups"][gi], r),
                                unit_views(opt_state["v"]["groups"][gi], r),
                                lr=lr, step=step)
                    x = h.detach()
                    group_loss = group_loss + total.detach()
                    g_sums[0] = g_sums[0] + gp / len(pattern)
                    g_sums[1] = g_sums[1] + gn / len(pattern)
                ff_losses.append(group_loss)
                aux_parts.append(group_aux)
            return x

        # the encoder first (encoder-decoder), FF-trained over the stub
        # frames; the decoder cross-attends to its normed output, a
        # vision config's blocks to the embeddings themselves
        cross_src = aux_in
        if cfg.enc_dec:
            xe = train_units(transformer.groups_of(cfg, encoder=True),
                             aux_in, ENC_REF)
            with torch.no_grad():
                cross_src = common.rms_norm(xe, params["enc_norm"],
                                            cfg.norm_eps)
        x = train_units(transformer.groups_of(cfg), x,
                        {**REF, "attn_impl": impl, "aux": cross_src})

        # ---- head: the paper's softmax layer (local CE) -----------------
        # CE on the positive half only (negatives carry no next-token
        # signal). For tied embeddings the table IS the softmax layer, so
        # it receives this grad too. ``enc_norm`` joins the head's Adam
        # step with a zero grad (the CE does not read it), as in the
        # reference, which leaves it unchanged.
        head_keys = ["final_norm"] + ([] if cfg.tie_embeddings
                                      else ["lm_head"])
        if cfg.enc_dec:
            head_keys.append("enc_norm")
        x_pos_h = x[:n_pos_here]
        hp = trainable({k: params[k] for k in head_keys})
        if cfg.tie_embeddings:
            hp["embed"] = params["embed"].detach().requires_grad_()
        with torch.enable_grad():
            ce_l = head_ce(x_pos_h, transformer.for_use(hp, cfg, dist), cfg,
                           lab_all[:n_pos_here], count=B * S, dist=dist)
            head_g = dict(zip(hp, grads_of(ce_l, hp)))
        emb_g_total = emb_g
        if cfg.tie_embeddings:
            emb_g_total = emb_g + head_g.pop("embed")
        emb_g_total, *head_g = part.grads(
            [emb_g_total] + [head_g[k] for k in head_keys],
            {"embed": params["embed"], **{k: params[k] for k in head_keys}})
        adam_leaves(params["embed"], [emb_g_total], opt_state["m"]["embed"],
                    opt_state["v"]["embed"], lr=lr, step=step)
        adam_leaves({k: params[k] for k in head_keys}, head_g,
                    {k: opt_state["m"][k] for k in head_keys},
                    {k: opt_state["v"][k] for k in head_keys},
                    lr=lr, step=step)

        # the whole batch's values: the ranks' parts summed in rank order,
        # each router aux counted once
        vals = part.total(torch.stack([emb_l, ce_l.detach(), *g_sums,
                                       *ff_losses]))
        emb_l, ce_l, gp, gn = vals[:4]
        ff_losses = [v - (part.n - 1) * a
                     for v, a in zip(vals[4:], aux_parts)]
        metrics.update(
            loss_embed=emb_l,
            loss_ff=sum(ff_losses) / max(len(ff_losses), 1),
            loss_ce=ce_l,
            goodness_pos=gp / n_units,
            goodness_neg=gn / n_units,
        )
        return params, opt_state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# Backprop baseline (the paper's comparison target)
# ---------------------------------------------------------------------------

def make_bp_train_step(cfg, *, dist=NO_DIST, lr=1e-3, attn_opts=AttnOpts()):
    """Standard end-to-end cross-entropy training step, every forward
    differentiated: the plain SSD, attention by ``REF``'s route
    (``attn_opts`` the chunked route's options). batch as
    ``make_ff_train_step`` takes it, its "aux" passed to the forward;
    ``dist`` as there: each rank runs its block of the batch's rows (the
    batch it is given), the CE of its vocab block of the logits
    (``vocab_ce``) summed over the whole batch's count."""
    part = RankPart(cfg, dist)

    def step_fn(params, opt_state, batch, step):
        tokens, aux = batch["tokens"], batch.get("aux")
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        tp = trainable(params)
        with torch.enable_grad():
            logits, aux_l = transformer.forward(tp, cfg, inp, aux=aux,
                                                dist=dist, impl="ref",
                                                attn_impl=REF["attn_impl"],
                                                attn_opts=attn_opts)
            ce = vocab_ce(logits, labels, transformer.vocab_block(
                cfg, dist, logits.shape[-1]))
            loss = torch.mean(ce) / part.n \
                + AUX_WEIGHT * aux_l
            grads = part.grads(grads_of(loss, tp), params)
        adam_leaves(params, grads, opt_state["m"], opt_state["v"], lr=lr,
                    step=step)
        # the router aux, whole on every rank, counted once
        loss = part.total(loss.detach()) \
            - (part.n - 1) * AUX_WEIGHT * aux_l.detach()
        return params, opt_state, {"loss_ce": loss}

    return step_fn


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def eval_ce(params, cfg, tokens, aux=None, *, impl="auto"):
    """Mean next-token CE of ``tokens`` (B, S+1) under ``params``, with
    the stub embeddings ``aux`` (B, T, d) where the config reads them:
    one no-grad forward (``impl`` routes its attention / SSD)."""
    with torch.no_grad():
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        logits, _ = transformer.forward(params, cfg, inp, aux=aux,
                                        impl=impl)
        lp = torch.log_softmax(logits, dim=-1)
        ce = -lp.gather(-1, labels.long()[..., None])[..., 0]
        return torch.mean(ce)
