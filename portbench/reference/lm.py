"""Plain PyTorch reference of FF chapter training of a dense GQA
transformer (Qwen2's block: arXiv:2407.10671).

Written from the models' equations, in float32 with TF32 off, one batch
row of attention at a time: pre-norm blocks with ``(1 + scale)`` RMS
norms, q/k/v projections with biases, half-split RoPE, causal GQA
softmax attention, the SiLU-gated MLP. FF chapter training (Hinton 2022;
arXiv:2404.08573): block k's grad step takes the embeddings of the
tokens and of their corruptions through the frozen blocks < k, then
block k's residual update y - x scores the goodness mean((y - x)^2);
the loss is softplus(theta - g) on the positives' positions and
softplus(g - theta) on the negatives'. The head step is the tied
softmax's cross-entropy over the last block's output under the final
norm. Adam updates the weights, which are stored in the configuration's
type. The corruptions (a batch-permuted donor's 16-token spans, 5% of
tokens resampled) are drawn from ``lib.keys``, the frozen copy of the
program's key rule. It imports nothing of the program.

``precision="fp8"`` rounds every product's operands to float8 e4m3 under
a per-tensor scale, and ``half_batch=True`` takes the loss over the first
half of the rows: the control and a planted fault, put in the program's
place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib.keys import Key

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
BLOCK_LEAVES = ("norm1", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "norm2",
                "wi", "wg", "wo_mlp")
FP8_MAX = 448.0


def fp8(t):
    """float8 e4m3 rounding under a per-tensor scale."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def _ein(eq, a, b, precision):
    if precision == "fp8":
        a, b = fp8(a), fp8(b)
    return torch.einsum(eq, a, b)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """x (B, S, H, hd): positions 0..S-1, half-split rotation."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, precision):
    """Causal GQA softmax attention, one batch row at a time."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    rows = []
    for b in range(B):
        kb = k[b].repeat_interleave(G, dim=1)            # (S, H, hd)
        vb = v[b].repeat_interleave(G, dim=1)
        s = _ein("qhd,khd->hqk", q[b], kb, precision) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        rows.append(_ein("hqk,khd->qhd", p, vb, precision))
    return torch.stack(rows)


def block(w, cfg, x, precision):
    """One block: x (B, S, d) -> (B, S, d); ``w`` holds one block's
    leaves in float32."""
    h = rms_norm(x, w["norm1"], cfg["norm_eps"])
    q = _ein("bsd,dhk->bshk", h, w["wq"], precision) + w["bq"]
    k = _ein("bsd,dhk->bshk", h, w["wk"], precision) + w["bk"]
    v = _ein("bsd,dhk->bshk", h, w["wv"], precision) + w["bv"]
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v, precision)
    x = x + _ein("bshk,hkd->bsd", o, w["wo"], precision)
    h = rms_norm(x, w["norm2"], cfg["norm_eps"])
    a = F.silu(_ein("bsd,df->bsf", h, w["wg"], precision)) \
        * _ein("bsd,df->bsf", h, w["wi"], precision)
    return x + _ein("bsf,fd->bsd", a, w["wo_mlp"], precision)


def unit(weights, j):
    return {n: weights[n][j].float() for n in BLOCK_LEAVES}


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), device=x.device))


def corrupt(key, tokens, vocab, frac=0.3, span=16):
    """Hybrid negatives: spans spliced from a batch-permuted donor, then
    5% of the tokens resampled uniformly."""
    B, S = tokens.shape
    dev = tokens.device
    k1, k2, k3, k4 = key.split(4)
    donor = tokens[k1.permutation(B).to(dev)]
    n_spans = max(S // span, 1)
    coarse = k2.bernoulli((B, n_spans), frac)
    mask = torch.repeat_interleave(coarse, -(-S // n_spans), dim=1)[:, :S]
    out = torch.where(mask.to(dev), donor, tokens)
    resample = k3.bernoulli((B, S), 0.05).to(dev)
    rand_tok = k4.randint((B, S), 0, vocab).to(dev, tokens.dtype)
    return torch.where(resample, rand_tok, out)


def adam(p, g, m, v, lr, step):
    """One Adam step on float32 moments; the weight is stored back in its
    own type."""
    t = torch.tensor(step, dtype=torch.float32)
    m.copy_(B1 * m + (1 - B1) * g)
    v.copy_(B2 * v + (1 - B2) * g * g)
    u = (m / (1.0 - B1 ** t)) / (torch.sqrt(v / (1.0 - B2 ** t)) + ADAM_EPS)
    p.copy_((p.float() - lr * u).to(p.dtype))


def _tf32_off(fn):
    def wrapped(*a, **kw):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **kw)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
    return wrapped


@_tf32_off
def follow_blocks(weights, cfg, batches, seed, lr, *, precision="f32",
                  half_batch=False):
    """Block k's grad step with global step number k + 1, for each of
    ``batches`` ((B, S + 1) token rows) in turn, from ``weights``
    (``lib.weights.lm``'s; the blocks it trains are copied). Returns
    {"loss": per step, "grad1": block 0's gradient at step 1,
    "params": the trained blocks' leaves after the last step}."""
    vocab, theta = cfg["vocab"], cfg["theta"]
    embed = weights["embed"].float()
    n = len(batches)
    blocks = [{nm: weights[nm][j].clone() for nm in BLOCK_LEAVES}
              for j in range(n)]
    out = {"loss": [], "grad1": {}}
    for step, tokens in enumerate(batches, start=1):
        k = step - 1
        tok = tokens[:, :-1]
        if half_batch:
            tok = tok[:tok.shape[0] // 2]
        B = tok.shape[0]
        neg = corrupt(Key(seed).fold_in(step), tok, vocab)
        with torch.no_grad():
            x = F.embedding(torch.cat([tok, neg]).long(), embed)
            for j in range(k):
                x = block({nm: t.float() for nm, t in blocks[j].items()},
                          cfg, x, precision)
        leaves = {nm: t.detach().float().clone().requires_grad_() for nm, t in
                  blocks[k].items()}
        with torch.enable_grad():
            y = block(leaves, cfg, x, precision)
            g = torch.mean((y - x) ** 2, dim=-1)
            per = torch.cat([_softplus(theta - g[:B]), _softplus(g[B:] - theta)])
            loss = torch.mean(per)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out["loss"].append(float(loss.detach()))
        for nm, gr in zip(leaves, grads):
            if step == 1:
                out["grad1"][nm] = gr.detach().clone()
            adam(blocks[k][nm], gr, torch.zeros_like(gr),
                 torch.zeros_like(gr), lr, step)
    out["params"] = {f"{j}.{nm}": blocks[j][nm] for j in range(n)
                     for nm in BLOCK_LEAVES}
    return out


@_tf32_off
def head_step(weights, cfg, tokens, *, precision="f32", half_batch=False,
              chunk=2048):
    """The head step's loss and its gradient of ``final_norm`` and the
    tied ``embed``, from ``weights`` (every block's state): the features
    of every block without grad, then the CE in row chunks, the padded
    vocabulary rows included in the softmax."""
    if half_batch:
        tokens = tokens[:tokens.shape[0] // 2]
    inp, labels = tokens[:, :-1], tokens[:, 1:].reshape(-1).long()
    embed = weights["embed"].float()
    with torch.no_grad():
        x = F.embedding(inp.long(), embed)
        for j in range(cfg["num_layers"]):
            x = block(unit(weights, j), cfg, x, precision)
    x = x.reshape(-1, x.shape[-1])
    fn = weights["final_norm"].float().requires_grad_()
    em = embed.requires_grad_()
    total = labels.numel()
    loss = 0.0
    g_fn, g_em = torch.zeros_like(fn), torch.zeros_like(em)
    for i in range(0, total, chunk):
        with torch.enable_grad():
            h = rms_norm(x[i:i + chunk], fn, cfg["norm_eps"])
            logits = _ein("td,vd->tv", h, em, precision)
            part = F.cross_entropy(logits, labels[i:i + chunk],
                                   reduction="sum") / total
            a, b = torch.autograd.grad(part, (fn, em))
        g_fn += a
        g_em += b
        loss += float(part.detach())
    return {"loss": [loss], "grad1": {"final_norm": g_fn, "embed": g_em}}
