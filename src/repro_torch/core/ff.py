"""Forward-Forward primitives (Hinton 2022, as used by the PFF paper):
goodness, the FF losses, the image label overlay and the negative-label
strategies, and the LM token corruption: the port of ``repro.core.ff``.

Random draws come from a key object (``core.rng``'s interface), passed
where the reference passes its jax key.

Image samples follow the paper: the first ``num_classes`` pixels of the
flattened image carry a one-hot label overlay (positive = true label,
negative = a wrong label, neutral = uniform 1/C for Softmax prediction).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def goodness(y):
    """Sum of squared activities over the feature axis (paper Eq. 1)."""
    return torch.sum(torch.square(y.float()), dim=-1)


def mean_goodness(y):
    """Dimension-normalized goodness: scale-free across layer widths."""
    return torch.mean(torch.square(y.float()), dim=-1)


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` switches to the identity above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ff_loss(g_pos, g_neg, theta):
    """Paper Eq. 1: -log sigma(g_pos - theta) - log sigma(theta - g_neg),
    as softplus terms, each a mean over the batch."""
    return (torch.mean(_softplus(theta - g_pos))
            + torch.mean(_softplus(g_neg - theta)))


def ff_loss_masked(g, is_pos, theta):
    """Mixed pos/neg batch. g: (B, ...), is_pos: (B,) in {0., 1.}."""
    while is_pos.dim() < g.dim():
        is_pos = is_pos[..., None]
    per = torch.where(is_pos > 0.5, _softplus(theta - g),
                      _softplus(g - theta))
    return torch.mean(per)


def peer_norm_loss(y):
    """Hinton's peer normalization: push mean activities toward their
    average (prevents dead/hyperactive units). y: (B, D) post-ReLU."""
    mean_act = torch.mean(y.float(), dim=0)                  # (D,)
    target = torch.mean(mean_act)
    return torch.mean(torch.square(mean_act - target))


def overlay_label(x, label, num_classes):
    """x: (B, D) in [0,1]; label: (B,) int or (B, C) float distribution."""
    if label.dim() == 1:
        lab = F.one_hot(label.long(), num_classes).to(x.dtype)
    else:
        lab = label.to(x.dtype)
    return torch.cat([lab, x[:, num_classes:]], dim=1)


def overlay_neutral(x, num_classes):
    lab = torch.full((x.shape[0], num_classes), 1.0 / num_classes,
                     dtype=x.dtype, device=x.device)
    return torch.cat([lab, x[:, num_classes:]], dim=1)


# ---------------------------------------------------------------------------
# Negative-label strategies (image tasks)
# ---------------------------------------------------------------------------

def random_wrong_labels(key, labels, num_classes):
    """Uniform over the C-1 wrong labels (RandomNEG / FixedNEG)."""
    shift = key.randint(labels.shape, 1, num_classes).to(labels.device,
                                                         labels.dtype)
    return (labels + shift) % num_classes


def adaptive_wrong_labels(class_scores, labels, key=None, temp=1.0):
    """AdaptiveNEG: pick a confusable wrong label from the model's
    per-class scores (B, C), higher = more predicted. The true label is
    masked out; with key=None takes the argmax, else samples in
    proportion to the scores z-scored over the WRONG-label columns only
    (the masked true column would bias mean and spread)."""
    B, C = class_scores.shape
    true_hot = F.one_hot(labels.long(), C).bool()
    neg_inf = torch.tensor(float("-inf"), device=class_scores.device)
    zero = torch.zeros((), device=class_scores.device)
    masked = torch.where(true_hot, neg_inf, class_scores)
    if key is None:
        return torch.argmax(masked, dim=1).to(labels.dtype)
    wrong = torch.where(true_hot, zero, class_scores)
    mu = torch.sum(wrong, dim=1, keepdim=True) / (C - 1)
    var = torch.sum(torch.where(true_hot, zero,
                                torch.square(class_scores - mu)),
                    dim=1, keepdim=True) / (C - 1)
    sd = torch.sqrt(var) + 1e-6
    z = torch.where(torch.isfinite(masked), (masked - mu) / sd, neg_inf)
    return key.categorical(z / temp).to(labels.device, labels.dtype)


# ---------------------------------------------------------------------------
# Negative sequences (LM tasks): the paper's wrong-label overlay adapted
# to tokens, hybrid sequences spliced from two real sequences (Hinton's
# hybrid-image recipe) plus random token resampling. The draws follow the
# reference's split chain, so a jax-backed key reproduces its negatives
# bit for bit.
# ---------------------------------------------------------------------------

def _span_mask(key, B, S, frac, span):
    """A coarse (B, S // span) Bernoulli grid upsampled to S (ceil-repeat
    + crop), on the CPU."""
    n_spans = max(S // span, 1)
    coarse = key.bernoulli((B, n_spans), frac)
    rep = -(-S // n_spans)
    return torch.repeat_interleave(coarse, rep, dim=1)[:, :S]


def corrupt_tokens(key, tokens, vocab, frac=0.3, span=16):
    """Hybrid negatives: splice spans from a batch-permuted copy, then
    resample a small fraction of tokens uniformly.

    tokens: (B, S) integer. Returns (B, S) negatives of tokens' dtype, on
    its device.
    """
    B, S = tokens.shape
    dev = tokens.device
    k1, k2, k3, k4 = key.split(4)
    donor = tokens[k1.permutation(B).to(dev)]
    mask = _span_mask(k2, B, S, frac, span).to(dev)
    out = torch.where(mask, donor, tokens)
    # sprinkle uniform-random tokens (keeps negatives off-manifold)
    resample = k3.bernoulli((B, S), 0.05).to(dev)
    rand_tok = k4.randint((B, S), 0, vocab).to(dev, tokens.dtype)
    return torch.where(resample, rand_tok, out)


def adaptive_corrupt_tokens(key, tokens, logits, frac=0.3, span=16):
    """AdaptiveNEG for LM: fill corrupted spans with tokens sampled from
    the model's own predictive distribution (self-generated negatives).

    logits: (B, S, V) from a no-grad forward with the current weights.
    """
    B, S = tokens.shape
    k1, k2 = key.split(2)
    model_tok = k1.categorical(logits).to(tokens.device, tokens.dtype)
    # shift: logits at position t predict t+1
    model_tok = torch.cat([tokens[:, :1], model_tok[:, :-1]], dim=1)
    mask = _span_mask(k2, B, S, frac, span).to(tokens.device)
    return torch.where(mask, model_tok, tokens)
