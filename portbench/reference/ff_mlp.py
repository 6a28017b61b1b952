"""Plain PyTorch reference of the FF chapter schedule of the paper's MLP.

What ``pff.run_chapter_schedule`` computes with the sumsq goodness,
AdaptiveNEG negatives and the goodness classifier, written from the
algorithm (Hinton 2022; arXiv:2404.08573 §3-§5.1) in float32 with TF32
off: per chapter, each layer takes its grad steps on [positives;
negatives], the normalized outputs feed the next layer, then every
training image is scored under each label overlay and a confusable
wrong label is drawn for its negative. Its random draws (epoch
permutations, wrong labels, AdaptiveNEG's Gumbel noise) come from
``lib.keys``, the frozen copy of the program's key rule. It imports
nothing of the program.

``precision="tf32"`` rounds every product's operands to TF32 (10 bits of
mantissa) and ``half_batch=True`` takes the loss over the first half of
the positives and of the negatives only: the control and a planted
fault, put in the program's place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib.keys import Key

NORM_EPS = 1e-8
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def tf32(t):
    """Round float32 to TF32 (nearest, ties away from zero); the gradient
    passes straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


def _mm(a, b, precision):
    if precision == "tf32":
        a, b = tf32(a), tf32(b)
    return a @ b


def _norm(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + NORM_EPS)


def _overlay(x, labels, C):
    return torch.cat([F.one_hot(labels.long(), C).to(x.dtype), x[:, C:]],
                     dim=1)


def _layer(lp, x, precision):
    y = torch.relu(_mm(x, lp["w"], precision) + lp["b"])
    return y, torch.sum(y * y, dim=1)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _lr(base, epoch, total, cooldown_after):
    frac = torch.tensor(epoch, dtype=torch.float32) / max(total, 1)
    return base * torch.clamp((1.0 - frac) / max(1.0 - cooldown_after, 1e-9),
                              0.0, 1.0)


def _adam(p, g, m, v, lr, step):
    t = torch.tensor(step, dtype=torch.float32)
    m.copy_(B1 * m + (1 - B1) * g)
    v.copy_(B2 * v + (1 - B2) * g * g)
    u = (m / (1.0 - B1 ** t)) / (torch.sqrt(v / (1.0 - B2 ** t)) + ADAM_EPS)
    p.copy_(p - lr * u)


def _scores(layers, x, C, precision, chunk=5000):
    """(n, C) accumulated goodness of layers 2..L under each label."""
    out = []
    for i in range(0, x.shape[0], chunk):
        xc = x[i:i + chunk]
        B = xc.shape[0]
        labels = torch.arange(C, device=x.device).repeat_interleave(B)
        h = _norm(_overlay(xc.repeat(C, 1), labels, C))
        total = torch.zeros(C * B, device=x.device)
        for j, lp in enumerate(layers):
            y, g = _layer(lp, h, precision)
            if j >= 1:
                total = total + g / y.shape[1]
            h = y / (torch.sqrt(g)[:, None] + NORM_EPS)
        out.append(total.reshape(C, B).T)
    return torch.cat(out)


def _wrong_labels(scores, y, key):
    """AdaptiveNEG: z-score the wrong labels' scores, Gumbel-max."""
    C = scores.shape[1]
    true = F.one_hot(y.long(), C).bool()
    zero = torch.zeros((), device=scores.device)
    wrong = torch.where(true, zero, scores)
    mu = wrong.sum(1, keepdim=True) / (C - 1)
    var = torch.where(true, zero, (scores - mu) ** 2).sum(1, keepdim=True) \
        / (C - 1)
    z = torch.where(true, torch.tensor(float("-inf"), device=scores.device),
                    (scores - mu) / (torch.sqrt(var) + 1e-6))
    return key.categorical(z).to(y.device, y.dtype)


@torch.no_grad()
def follow(x, y, layers, run, seed, chapters, *, precision="f32",
           half_batch=False):
    """Follows the first ``chapters`` chapters from ``layers`` (a list of
    {"w", "b"}, copied). ``run``: the configuration and traffic
    (``layer_sizes``, ``num_classes``, ``theta``, ``lr_ff``, ``epochs``,
    ``splits``, ``cooldown_after``, ``batch``). Returns {"grad1": the
    first chapter's gradient of each leaf, "params": each leaf after the
    last chapter, "labels": the negatives' labels after each chapter,
    "loss": each layer's first loss}. "grad1" is Adam's first moment
    after the first chapter over 1 - b1: the first gradient where a
    chapter is one grad step."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(x, y, layers, run, seed, chapters, precision,
                       half_batch)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _follow(x, y, layers, run, seed, chapters, precision, half_batch):
    C, n, batch = run["num_classes"], x.shape[0], run["batch"]
    epochs_per = max(run["epochs"] // run["splits"], 1)
    layers = [{k: t.clone() for k, t in lp.items()} for lp in layers]
    state = [({k: torch.zeros_like(t) for k, t in lp.items()},
              {k: torch.zeros_like(t) for k, t in lp.items()})
             for lp in layers]
    key = Key(seed)
    kneg = key.fold_in(999)
    xp0 = _norm(_overlay(x, y, C))
    shift = kneg.randint(y.shape, 1, C).to(y.device, y.dtype)
    xn0 = _norm(_overlay(x, (y + shift) % C, C))
    out = {"grad1": {}, "loss": [], "labels": []}
    for c in range(chapters):
        kc = key.fold_in(c)
        acts = (xp0, xn0)
        for k, lp in enumerate(layers):
            kk = kc.fold_in(k)
            m, v = state[k]
            step = 0
            for e in range(epochs_per):
                lr = _lr(run["lr_ff"], c * epochs_per + e, run["epochs"],
                         run["cooldown_after"])
                # every batch full: the permutation wraps round
                total = -(-n // batch) * batch
                perm = kk.fold_in(e).permutation(n)
                perm = perm.repeat(-(-total // n))[:total].to(x.device)
                for i in range(0, total, batch):
                    idx = perm[i:i + batch]
                    if half_batch:
                        idx = idx[:len(idx) // 2]
                    xb = torch.cat([acts[0][idx], acts[1][idx]])
                    with torch.enable_grad():
                        w = lp["w"].detach().requires_grad_()
                        b = lp["b"].detach().requires_grad_()
                        yb, g = _layer({"w": w, "b": b}, xb, precision)
                        g = g / yb.shape[1]
                        h = len(idx)
                        loss = (torch.mean(_softplus(run["theta"] - g[:h]))
                                + torch.mean(_softplus(g[h:] - run["theta"])))
                        gw, gb = torch.autograd.grad(loss, (w, b))
                    step += 1
                    if c == 0 and step == 1:
                        out["loss"].append(float(loss.detach()))
                    _adam(lp["w"], gw, m["w"], v["w"], lr, step)
                    _adam(lp["b"], gb, m["b"], v["b"], lr, step)
            if c == 0:
                for name in ("w", "b"):
                    out["grad1"][f"{k}.{name}"] = m[name] / (1 - B1)
            if k + 1 < len(layers):
                acts = tuple(_norm_fwd(lp, a, precision) for a in acts)
        scores = _scores(layers, x, C, precision)
        labels = _wrong_labels(scores, y, kneg.fold_in(c))
        out["labels"].append(labels)
        xn0 = _norm(_overlay(x, labels, C))
    out["params"] = {f"{k}.{n_}": lp[n_] for k, lp in enumerate(layers)
                     for n_ in ("w", "b")}
    return out


def _norm_fwd(lp, a, precision):
    yv, g = _layer(lp, a, precision)
    return yv / (torch.sqrt(g)[:, None] + NORM_EPS)
