"""The paper's network, [784, 2000, 2000, 2000, 2000] ReLU MLP trained
with Forward-Forward, layer by layer, in chapters: the port's
parameters, chapter trainers and prediction path
(``repro.core.ff_mlp``'s counterpart).

Faithful details kept from the reference:
  * label overlay on the first C pixels (pos = true, neg = wrong label)
  * goodness = sum of squared activities, loss = softplus(±(theta - g))
  * activity vectors are length-normalized between layers (Hinton); the
    divide is the ``norm=True`` epilogue of the fused ``ff_dense``
  * Adam per layer; LR cooldown after half the epochs (paper §5.1)
  * goodness prediction accumulates layers 2..L (all but the first)
  * the softmax head reads normalized activations of layers 2..L and is
    trained layer-locally (it never propagates into FF layers)
  * Performance-Optimized goodness: per-layer softmax head trained with
    two-layer-deep backprop, no negative data (paper §4.4)

Parameters are plain dicts of tensors in the reference's layout, so
``convert.params_from_numpy`` carries a reference tree over leaf by leaf.
Everything here runs eagerly on the parameters' device. The chapter
trainers take gradients with ``torch.autograd.grad`` over leaf views of
the trained parameters and update params and Adam state IN PLACE (the
counterpart of the reference's donated buffers): a caller that needs the
old values copies them first. Their random draws come from a key
(``core.rng``), folded exactly as the reference folds its jax key.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.core import ff, strategies
from repro_torch.device import resolve_device
from repro_torch.kernels import ff_dense as kernels_ff_dense, ops


def _norm(x, eps=kernels_ff_dense.NORM_EPS):
    """Hinton's length normalization of RAW inputs (label overlays)
    before the first layer. Between layers the divide is fused into the
    ``ff_dense`` epilogue (``norm=True``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def fwd_norm(lp, x, impl="auto"):
    """One layer forward + Hinton length-norm: the inter-layer hand-off
    of the chapter trainer, one ``ff_dense`` call with the divide in the
    kernel's epilogue. Forward only: callers run it under
    ``torch.no_grad()``."""
    yn, _ = ops.ff_dense(x, lp["w"], lp["b"], impl=impl, norm=True)
    return yn


def kernel_impl(cfg):
    """The config's ``ops.ff_dense`` path (auto | cuda | ref)."""
    return getattr(cfg, "kernel_impl", "auto")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _sources(src, n):
    """``n`` sources for ``n`` successive draws: a ``torch.Generator``
    serves them all in turn; a key is split ``n`` ways, as the
    reference splits its jax key."""
    if isinstance(src, torch.Generator):
        return [src] * n
    return src.split(n)


def _normal(src, shape):
    if isinstance(src, torch.Generator):
        return torch.randn(*shape, generator=src)
    return src.normal(shape)


def init(cfg, generator, device=None):
    """Random parameters in the reference's layout and scaling, drawn on
    the CPU and moved to ``device`` (default ``cuda``; see
    ``device.resolve_device``). ``generator`` is a CPU
    ``torch.Generator`` or a key (``core.rng``), which is split as the
    reference's ``init`` splits its jax key."""
    dev = resolve_device(device)
    sizes = cfg.layer_sizes
    n_hidden = len(sizes) - 1
    ks = _sources(generator, n_hidden + 1)
    layers = []
    for i in range(n_hidden):
        w = _normal(ks[i], (sizes[i], sizes[i + 1])) * sizes[i] ** -0.5
        layers.append({"w": w, "b": torch.zeros(sizes[i + 1])})
    # layers 2..L feed the head (all of them for a 1-hidden-layer net)
    feat_dim = sum(sizes[2:]) or sizes[-1]
    head = {"w": _normal(ks[-1], (feat_dim, cfg.num_classes))
            * feat_dim ** -0.5,
            "b": torch.zeros(cfg.num_classes)}
    params = {"layers": layers, "head": head}
    extras_init = strategies.goodness.get(cfg.goodness_fn).init_extras
    if extras_init is not None:
        params.update(extras_init(ks[-1], cfg))
    return tree_map(lambda t: t.to(dev), params)


def opt_init(params):
    out = {"layers": [optim.adam_init(lp) for lp in params["layers"]],
           "head": optim.adam_init(params["head"])}
    if "local_heads" in params:
        out["local_heads"] = [optim.adam_init(h)
                              for h in params["local_heads"]]
    return out


def layer_apply(lp, x):
    return torch.relu(x @ lp["w"] + lp["b"])


# ---------------------------------------------------------------------------
# Layer-local training (one chapter = C mini-epochs over all batches)
# ---------------------------------------------------------------------------

def _num_batches(n, batch):
    """Batches per mini-epoch, tail included (ceil division)."""
    return -(-n // batch)


def _epoch_perm(key, ei, n, batch):
    """Shuffled sample order for mini-epoch ``ei`` (int64, on the CPU),
    padded to a whole number of batches by WRAPPING the permutation:
    every sample is consumed at least once per mini-epoch and every
    batch is full. Tiling (not a single wrap) also covers n < batch."""
    perm = key.fold_in(ei).permutation(n).long()
    total = _num_batches(n, batch) * batch
    if total > n:
        perm = perm.repeat(-(-total // n))[:total]
    return perm


def _grad(loss_fn, tree, *args):
    """d loss_fn(tree, *args) / d tree, as a tree of the same shape,
    taken over leaf views of ``tree``'s tensors."""
    leaf = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(loss_fn(leaf, *args),
                                         tree_leaves(leaf)))
    return tree_map(lambda _: next(grads), leaf)


def _ff_layer_loss(lp, xb, theta, peer_w, impl="auto"):
    """FF objective over a stacked [pos; neg] batch xb: (2B, K), ONE
    ``ff_dense`` call. Goodness is the MEAN of squared activities with
    theta ~ 2 (one theta across layer widths)."""
    y, g = ops.ff_dense(xb, lp["w"], lp["b"], impl=impl)
    g = g / y.shape[-1]                       # sum-of-squares -> mean
    half = xb.shape[0] // 2
    loss = ff.ff_loss(g[:half], g[half:], theta)
    if peer_w:
        loss = loss + peer_w * ff.peer_norm_loss(y[:half])
    return loss


def train_layer_chapter(lp, opt, x_pos, x_neg, lrs, key, *, batch, epochs,
                        theta, peer_w=0.0, impl="auto"):
    """Trains one layer for ``epochs`` mini-epochs. x_pos/x_neg are this
    layer's (already normalized) inputs over the whole train set; lrs:
    (epochs,) float32 learning rate per mini-epoch (cooldown-aware).
    lp/opt are updated in place and returned."""
    n = x_pos.shape[0]
    n_batches = _num_batches(n, batch)
    step = 0
    for ei in range(epochs):
        perm = _epoch_perm(key, ei, n, batch).to(x_pos.device)
        for bi in range(n_batches):
            idx = perm[bi * batch:(bi + 1) * batch]
            xb = torch.cat([x_pos[idx], x_neg[idx]], dim=0)
            g = _grad(_ff_layer_loss, lp, xb, theta, peer_w, impl)
            step += 1
            lp, opt = optim.adam_update(lp, g, opt, lr=lrs[ei], step=step)
    return lp, opt


def _perf_opt_loss(lp_and_head, xb, yb, impl="auto"):
    """§4.4 local-head loss: activation, normalizer and the norm divide
    from one ``ff_dense`` call (norm=True); the small (N, C) head matmul
    stays a plain product."""
    lp, head = lp_and_head
    yn, _ = ops.ff_dense(xb, lp["w"], lp["b"], impl=impl, norm=True)
    logits = yn @ head["w"] + head["b"]
    rows = torch.arange(xb.shape[0], device=xb.device)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[rows, yb.long()])


def train_layer_chapter_perf_opt(lp, head, opt, opt_h, x, y, lrs, key, *,
                                 batch, epochs, impl="auto"):
    """Performance-Optimized goodness (paper §4.4): train (layer, local
    softmax head) with two-layer backprop; no negative data. All four
    trees are updated in place and returned."""
    n = x.shape[0]
    n_batches = _num_batches(n, batch)
    step = 0
    for ei in range(epochs):
        perm = _epoch_perm(key, ei, n, batch).to(x.device)
        for bi in range(n_batches):
            idx = perm[bi * batch:(bi + 1) * batch]
            g_lp, g_h = _grad(_perf_opt_loss, (lp, head), x[idx], y[idx],
                              impl)
            step += 1
            lp, opt = optim.adam_update(lp, g_lp, opt, lr=lrs[ei],
                                        step=step)
            head, opt_h = optim.adam_update(head, g_h, opt_h, lr=lrs[ei],
                                            step=step)
    return lp, head, opt, opt_h


def _head_loss(head, feats, y):
    logits = feats @ head["w"] + head["b"]
    rows = torch.arange(y.shape[0], device=y.device)
    return torch.mean(-torch.log_softmax(logits, dim=-1)[rows, y.long()])


def train_head_chapter(head, opt, feats, y, lrs, key, *, batch, epochs):
    """Softmax head on concatenated normalized feats of layers 2..L.
    head/opt are updated in place and returned."""
    n = feats.shape[0]
    n_batches = _num_batches(n, batch)
    step = 0
    for ei in range(epochs):
        perm = _epoch_perm(key, ei, n, batch).to(feats.device)
        for bi in range(n_batches):
            idx = perm[bi * batch:(bi + 1) * batch]
            g = _grad(_head_loss, head, feats[idx], y[idx])
            step += 1
            head, opt = optim.adam_update(head, g, opt, lr=lrs[ei],
                                          step=step)
    return head, opt


# ---------------------------------------------------------------------------
# Prediction / evaluation
# ---------------------------------------------------------------------------

def accumulated_goodness(layers_params, x, impl="auto"):
    """Goodness of layers 2..L (all but first), summed; x already
    label-overlaid. Returns (B,). Each layer is ONE ``ff_dense`` call
    computing activation, goodness and the next layer's normalized
    input."""
    hn = _norm(x)
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    skip_first = len(layers_params) > 1
    for i, lp in enumerate(layers_params):
        # the last layer's normalized output feeds nothing: skip the
        # epilogue's divide there
        feeds_next = i + 1 < len(layers_params)
        yn, g = ops.ff_dense(hn, lp["w"], lp["b"], impl=impl,
                             norm=feeds_next)
        if i >= 1 or not skip_first:
            total = total + g / yn.shape[-1]
        hn = yn
    return total


def goodness_class_scores(params, x, num_classes, impl="auto"):
    """(B, C) accumulated-goodness score per candidate label.

    All C label overlays are stacked as rows ``c*B + b`` of one
    (C*B, D) batch, so the sweep is ONE ``ff_dense`` call per layer."""
    B, D = x.shape
    xs = x.unsqueeze(0).expand(num_classes, B, D).reshape(
        num_classes * B, D)
    labels = torch.arange(num_classes,
                          device=x.device).repeat_interleave(B)
    xc = ff.overlay_label(xs, labels, num_classes)
    scores = accumulated_goodness(params["layers"], xc, impl=impl)
    return scores.reshape(num_classes, B).T


def softmax_feats(layers_params, x, impl="auto"):
    """Normalized activations of layers 2..L, concatenated (all layers
    for a 1-hidden-layer net); one ``ff_dense`` call per layer."""
    feats = []
    hn = _norm(x)
    for lp in layers_params:
        hn, _ = ops.ff_dense(hn, lp["w"], lp["b"], impl=impl, norm=True)
        feats.append(hn)
    if len(feats) > 1:
        feats = feats[1:]
    return torch.cat(feats, dim=-1)


def perf_opt_scores(params, x, last_only=False, impl="auto"):
    """Performance-Optimized prediction (paper Table 4): sum the local
    classifier log-softmax over all layers, or use only the last one's."""
    hn = _norm(x)
    total = None
    for lp, head in zip(params["layers"], params["local_heads"]):
        hn, _ = ops.ff_dense(hn, lp["w"], lp["b"], impl=impl, norm=True)
        logits = torch.log_softmax(hn @ head["w"] + head["b"], dim=-1)
        total = logits if (total is None or last_only) else total + logits
    return total


def class_scores(params, x, num_classes, mode="goodness", impl="auto"):
    """(B, C) label scores via the classifier strategy registry."""
    strat = strategies.classifier.get(mode)
    return strat.scores(params, x, num_classes=num_classes, impl=impl)


def predict(params, x, num_classes, mode="goodness", impl="auto"):
    return torch.argmax(class_scores(params, x, num_classes, mode,
                                     impl=impl), dim=1)


def chunked_scores(score_fn, x, chunk=2000, device=None):
    """Applies ``score_fn`` over the host array ``x`` in chunks moved to
    ``device`` (bounding the sweep's memory: each chunk expands C-fold
    inside the goodness scorer) and concatenates along axis 0."""
    dev = resolve_device(device)
    outs = [score_fn(torch.as_tensor(x[i:i + chunk], device=dev))
            for i in range(0, len(x), chunk)]
    return torch.cat(outs, dim=0)


def accuracy(params, x, y, num_classes, mode="goodness", chunk=2000,
             impl="auto"):
    """Share of host rows ``x`` whose predicted label equals ``y``,
    scored on the parameters' device."""
    dev = params["layers"][0]["w"].device
    scores = chunked_scores(
        lambda xc: class_scores(params, xc, num_classes, mode, impl=impl),
        x, chunk=chunk, device=dev)
    pred = torch.argmax(scores, dim=1).cpu()
    return float(torch.mean((pred == torch.as_tensor(y)).float()))


# ---------------------------------------------------------------------------
# Builtin strategies (see core.strategies)
# ---------------------------------------------------------------------------

def _sumsq_get_state(params, opt, k):
    return (params["layers"][k], opt["layers"][k])


def _sumsq_set_state(params, opt, k, state):
    params["layers"][k], opt["layers"][k] = state


def _sumsq_train_chapter(state, acts, extras, lrs, key, *, cfg, epochs):
    lp, o = state
    xp, xn = acts
    return train_layer_chapter(
        lp, o, xp, xn, lrs, key, batch=cfg.batch_size, epochs=epochs,
        theta=cfg.theta, peer_w=cfg.peer_w, impl=kernel_impl(cfg))


def _perf_opt_init_extras(src, cfg):
    sizes = cfg.layer_sizes
    n_hidden = len(sizes) - 1
    kk = _sources(src, n_hidden)
    return {"local_heads": [
        {"w": _normal(kk[i], (sizes[i + 1], cfg.num_classes))
         * sizes[i + 1] ** -0.5,
         "b": torch.zeros(cfg.num_classes)}
        for i in range(n_hidden)]}


def _perf_opt_get_state(params, opt, k):
    return (params["layers"][k], params["local_heads"][k],
            opt["layers"][k], opt["local_heads"][k])


def _perf_opt_set_state(params, opt, k, state):
    (params["layers"][k], params["local_heads"][k],
     opt["layers"][k], opt["local_heads"][k]) = state


def _perf_opt_train_chapter(state, acts, extras, lrs, key, *, cfg, epochs):
    lp, head, o, oh = state
    (xk,) = acts
    (y,) = extras
    return train_layer_chapter_perf_opt(
        lp, head, o, oh, xk, y, lrs, key, batch=cfg.batch_size,
        epochs=epochs, impl=kernel_impl(cfg))


strategies.register_goodness("sumsq", strategies.GoodnessStrategy(
    name="sumsq", uses_negatives=True,
    get_state=_sumsq_get_state, set_state=_sumsq_set_state,
    train_chapter=_sumsq_train_chapter,
    export=lambda states: {"layers": [s[0] for s in states]},
    eval_mode=lambda cfg: cfg.classifier))

strategies.register_goodness("perf_opt", strategies.GoodnessStrategy(
    name="perf_opt", uses_negatives=False,
    get_state=_perf_opt_get_state, set_state=_perf_opt_set_state,
    train_chapter=_perf_opt_train_chapter,
    export=lambda states: {"layers": [s[0] for s in states],
                           "local_heads": [s[1] for s in states]},
    # honor an explicitly chosen classifier; only remap the config
    # DEFAULT ("goodness"), which scores label overlays the §4.4 layers
    # never saw
    eval_mode=lambda cfg: ("perf_opt_all" if cfg.classifier == "goodness"
                           else cfg.classifier),
    init_extras=_perf_opt_init_extras))


def _goodness_cls_scores(params, x, *, num_classes, impl="auto"):
    return goodness_class_scores(params, x, num_classes, impl=impl)


def _softmax_cls_scores(params, x, *, num_classes, impl="auto"):
    xn = ff.overlay_neutral(x, num_classes)
    feats = softmax_feats(params["layers"], xn, impl=impl)
    return feats @ params["head"]["w"] + params["head"]["b"]


def _perf_opt_cls_scores(last_only):
    def scores(params, x, *, num_classes, impl="auto"):
        xn = ff.overlay_neutral(x, num_classes)
        return perf_opt_scores(params, xn, last_only=last_only, impl=impl)
    return scores


strategies.register_classifier("goodness", _goodness_cls_scores)
strategies.register_classifier("softmax", _softmax_cls_scores,
                               trains_head=True)
strategies.register_classifier("perf_opt_all", _perf_opt_cls_scores(False),
                               requires_goodness="perf_opt")
strategies.register_classifier("perf_opt_last", _perf_opt_cls_scores(True),
                               requires_goodness="perf_opt")
