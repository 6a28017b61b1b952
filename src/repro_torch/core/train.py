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
plain attention and SSD, which autograd differentiates (the CUDA kernels
have no backward and refuse inputs that need one, ``kernels/guard.py``).
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

from repro_torch import optim
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import ff
from repro_torch.core.rng import TorchKey
from repro_torch.models import blocks, common, transformer

AUX_WEIGHT = 0.01      # router load-balance weight (local per block)
CE_CHUNK = 512         # sequence chunk for vocab-logit computation
REF = {"causal": True, "impl": "ref"}   # ctx of a differentiated forward
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


def _ce_chunk(hc, lc, mc, w, softcap):
    logits = torch.einsum("bsd,vd->bsv", hc.float(), w.float())
    logits = common.softcap(logits, softcap)
    lp = torch.log_softmax(logits, dim=-1)
    ce = -lp.gather(-1, lc[..., None])[..., 0]
    return torch.sum(ce * mc)


def _ce_chunked(h, w_unembed, labels, mask, softcap=0.0):
    """Cross-entropy without holding (B, S, V) logits for the backward.

    One sequence chunk at a time; each chunk's logits are recomputed in
    the backward (``torch.utils.checkpoint``), so the backward never
    holds more than one chunk's logits either.
    h: (B, S, d); w_unembed: (V, d); labels/mask: (B, S).
    Returns summed CE (summed mask weight is the caller's).
    """
    B, S, d = h.shape
    if tuple(labels.shape) != (B, S):
        # the reference's chunk reshape fails on such inputs too (perf_opt
        # scores an encoder's frames against the token labels)
        raise ValueError(f"labels {tuple(labels.shape)} do not match the "
                         f"features' (batch, positions) {(B, S)}")
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
                w_unembed, softcap)
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                _ce_chunk, *args, use_reentrant=False)
        else:
            part = _ce_chunk(*args)
        total = total + part
    return total


def _local_ce(h, embed_sg, labels, mask):
    """Local classifier loss via the (detached) embedding table."""
    z = common.rms_normalize(h)
    total = _ce_chunked(z, embed_sg, labels, mask)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def head_ce(x, hp, cfg, labels):
    """The softmax head's CE on features ``x`` (detached by the caller):
    ``final_norm``, then the tied table or ``lm_head`` as the softmax
    layer (pad rows unmasked, as the reference has them)."""
    h = common.rms_norm(x, hp["final_norm"], cfg.norm_eps)
    w = hp["embed"] if cfg.tie_embeddings else hp["lm_head"].T
    ones = torch.ones(labels.shape, device=x.device)
    total = _ce_chunked(h, w, labels, ones, softcap=cfg.logit_softcap)
    return total / labels.numel()


# ---------------------------------------------------------------------------
# FF train step (joint: every block each step)
# ---------------------------------------------------------------------------

def make_ff_train_step(cfg, *, lr=1e-3, seed=0, key_fn=TorchKey,
                       impl="auto"):
    """Returns step_fn(params, opt_state, batch, step) ->
    (params, opt_state, metrics), params and state updated in place.

    batch: {"tokens": (B, S+1) integer tensor, optional "aux": (B, T, d)
    stub frontend embeddings}. opt_state: ``optim.adam_init(params)``.
    ``impl`` routes the no-grad forward of AdaptiveNEG
    (``cfg.ff.neg_mode == "adaptive"``).
    """
    perf_opt = cfg.ff.goodness == "perf_opt"
    theta = cfg.ff.theta
    n_units = sum(r for _, _, r, _ in transformer.group_infos(cfg))

    def step_fn(params, opt_state, batch, step):
        tokens = batch["tokens"]
        B, S1 = tokens.shape
        S = S1 - 1
        dev = tokens.device
        pos_tok, labels = tokens[:, :-1], tokens[:, 1:]
        aux_in = batch.get("aux")
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
                    logits0, _ = transformer.forward(params, cfg, pos_tok,
                                                     aux=aux_in, impl=impl)
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
        if aux_in is not None and x_tok.shape[0] != aux_in.shape[0]:
            aux_in = torch.cat([aux_in, aux_in], dim=0)

        embed_sg = params["embed"].detach()
        ce_mask = is_pos[:, None] * torch.ones((1, S), device=dev)

        # ---- embedding: FF layer 1 (local loss); grad now, update later
        # (tied archs add the head-CE grad below)
        with torch.enable_grad():
            emb = params["embed"].detach().requires_grad_()
            h = F.embedding(x_tok.long(), emb)
            if perf_opt:
                emb_l = _local_ce(h, embed_sg, lab_all, ce_mask)
            else:
                g = ff.mean_goodness(common.rms_normalize(h))
                emb_l = ff.ff_loss_masked(g, is_pos, theta)
            (emb_g,) = torch.autograd.grad(emb_l, [emb])
        metrics["loss_embed"] = emb_l.detach()
        x = h.detach()

        # ---- the stacks: each unit's grad and Adam update, in order ------
        ff_losses = []
        g_sums = [torch.zeros((), device=dev), torch.zeros((), device=dev)]
        npos = torch.clamp(is_pos.sum(), min=1.0)
        nneg = torch.clamp((1 - is_pos).sum(), min=1.0)

        def train_units(groups, x, ctx):
            for gi, pattern, repeat in groups:
                group_loss = torch.zeros((), device=dev)
                for r in range(repeat):
                    unit = unit_views(params["groups"][gi], r)
                    up = trainable(unit)
                    with torch.enable_grad():
                        h = x
                        total = torch.zeros((), device=dev)
                        gp = torch.zeros((), device=dev)
                        gn = torch.zeros((), device=dev)
                        for kind, bp in zip(pattern, up):
                            h_sg = h.detach()
                            y, moe_aux = blocks.block_apply(bp, cfg, kind,
                                                            h_sg, ctx)
                            if perf_opt:
                                loss = _local_ce(y, embed_sg, lab_all,
                                                 ce_mask)
                            else:
                                loss, g = _block_ff_loss(y - h_sg, is_pos,
                                                         theta)
                                gm = g.detach().mean(1)
                                gp = gp + (gm * is_pos).sum() / npos
                                gn = gn + (gm * (1 - is_pos)).sum() / nneg
                            total = total + loss + AUX_WEIGHT * moe_aux
                            h = y
                        grads = grads_of(total, up)
                    adam_leaves(unit, grads,
                                unit_views(opt_state["m"]["groups"][gi], r),
                                unit_views(opt_state["v"]["groups"][gi], r),
                                lr=lr, step=step)
                    x = h.detach()
                    group_loss = group_loss + total.detach()
                    g_sums[0] = g_sums[0] + gp / len(pattern)
                    g_sums[1] = g_sums[1] + gn / len(pattern)
                ff_losses.append(group_loss)
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
                        {**REF, "aux": cross_src})

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
        x_pos_h = x if perf_opt else x[:B]
        hp = trainable({k: params[k] for k in head_keys})
        if cfg.tie_embeddings:
            hp["embed"] = params["embed"].detach().requires_grad_()
        with torch.enable_grad():
            ce_l = head_ce(x_pos_h, hp, cfg, labels)
            head_g = dict(zip(hp, grads_of(ce_l, hp)))
        emb_g_total = emb_g
        if cfg.tie_embeddings:
            emb_g_total = emb_g + head_g.pop("embed")
        adam_leaves(params["embed"], [emb_g_total], opt_state["m"]["embed"],
                    opt_state["v"]["embed"], lr=lr, step=step)
        adam_leaves({k: params[k] for k in head_keys},
                    [head_g[k] for k in head_keys],
                    {k: opt_state["m"][k] for k in head_keys},
                    {k: opt_state["v"][k] for k in head_keys},
                    lr=lr, step=step)

        metrics.update(
            loss_ff=sum(ff_losses) / max(len(ff_losses), 1),
            loss_ce=ce_l.detach(),
            goodness_pos=g_sums[0] / n_units,
            goodness_neg=g_sums[1] / n_units,
        )
        return params, opt_state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# Backprop baseline (the paper's comparison target)
# ---------------------------------------------------------------------------

def make_bp_train_step(cfg, *, lr=1e-3):
    """Standard end-to-end cross-entropy training step, through the plain
    route (every forward here is differentiated). batch as
    ``make_ff_train_step`` takes it, its "aux" passed to the forward."""

    def step_fn(params, opt_state, batch, step):
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        tp = trainable(params)
        with torch.enable_grad():
            logits, aux_l = transformer.forward(tp, cfg, inp,
                                                aux=batch.get("aux"),
                                                impl="ref")
            lp = torch.log_softmax(logits, dim=-1)
            ce = -lp.gather(-1, labels.long()[..., None])[..., 0]
            loss = torch.mean(ce) + AUX_WEIGHT * aux_l
            grads = grads_of(loss, tp)
        adam_leaves(params, grads, opt_state["m"], opt_state["v"], lr=lr,
                    step=step)
        return params, opt_state, {"loss_ce": loss.detach()}

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
