"""The paper's network, [784, 2000, 2000, 2000, 2000] ReLU MLP trained
with Forward-Forward: the port's parameters and prediction path
(``repro.core.ff_mlp``'s counterpart). The chapter trainers come with
the training slice.

Faithful details kept from the reference:
  * label overlay on the first C pixels
  * goodness = sum of squared activities
  * activity vectors are length-normalized between layers (Hinton); the
    divide is the ``norm=True`` epilogue of the fused ``ff_dense``
  * goodness prediction accumulates layers 2..L (all but the first)
  * the softmax head reads normalized activations of layers 2..L
  * Performance-Optimized prediction sums per-layer local-head logits

Parameters are plain dicts of tensors in the reference's layout, so
``convert.params_from_numpy`` carries a reference tree over leaf by leaf.
Everything here runs eagerly on the parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.convert import tree_map
from repro_torch.core import ff, strategies
from repro_torch.device import resolve_device
from repro_torch.kernels import ff_dense as kernels_ff_dense, ops


def _norm(x, eps=kernels_ff_dense.NORM_EPS):
    """Hinton's length normalization of RAW inputs (label overlays)
    before the first layer. Between layers the divide is fused into the
    ``ff_dense`` epilogue (``norm=True``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def kernel_impl(cfg):
    """The config's ``ops.ff_dense`` path (auto | cuda | ref)."""
    return getattr(cfg, "kernel_impl", "auto")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init(cfg, generator, device=None):
    """Random parameters in the reference's layout and scaling, drawn on
    the CPU from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device`` (default ``cuda``; see ``device.resolve_device``)."""
    dev = resolve_device(device)
    sizes = cfg.layer_sizes
    layers = []
    for i in range(len(sizes) - 1):
        w = torch.randn(sizes[i], sizes[i + 1],
                        generator=generator) * sizes[i] ** -0.5
        layers.append({"w": w, "b": torch.zeros(sizes[i + 1])})
    # layers 2..L feed the head (all of them for a 1-hidden-layer net)
    feat_dim = sum(sizes[2:]) or sizes[-1]
    head = {"w": torch.randn(feat_dim, cfg.num_classes,
                             generator=generator) * feat_dim ** -0.5,
            "b": torch.zeros(cfg.num_classes)}
    params = {"layers": layers, "head": head}
    extras_init = strategies.goodness.get(cfg.goodness_fn).init_extras
    if extras_init is not None:
        params.update(extras_init(generator, cfg))
    return tree_map(lambda t: t.to(dev), params)


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

def _train_slice_pending(*args, **kwargs):
    raise NotImplementedError(
        "chapter training is not ported yet: it comes with the training "
        "slice (the ff_dense backward kernel, optim, the chapter "
        "trainers and api.fit)")


def _sumsq_get_state(params, opt, k):
    return (params["layers"][k], opt["layers"][k])


def _sumsq_set_state(params, opt, k, state):
    params["layers"][k], opt["layers"][k] = state


def _perf_opt_init_extras(generator, cfg):
    sizes = cfg.layer_sizes
    return {"local_heads": [
        {"w": torch.randn(sizes[i + 1], cfg.num_classes,
                          generator=generator) * sizes[i + 1] ** -0.5,
         "b": torch.zeros(cfg.num_classes)}
        for i in range(len(sizes) - 1)]}


def _perf_opt_get_state(params, opt, k):
    return (params["layers"][k], params["local_heads"][k],
            opt["layers"][k], opt["local_heads"][k])


def _perf_opt_set_state(params, opt, k, state):
    (params["layers"][k], params["local_heads"][k],
     opt["layers"][k], opt["local_heads"][k]) = state


strategies.register_goodness("sumsq", strategies.GoodnessStrategy(
    name="sumsq", uses_negatives=True,
    get_state=_sumsq_get_state, set_state=_sumsq_set_state,
    train_chapter=_train_slice_pending,
    export=lambda states: {"layers": [s[0] for s in states]},
    eval_mode=lambda cfg: cfg.classifier))

strategies.register_goodness("perf_opt", strategies.GoodnessStrategy(
    name="perf_opt", uses_negatives=False,
    get_state=_perf_opt_get_state, set_state=_perf_opt_set_state,
    train_chapter=_train_slice_pending,
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
