"""Plain PyTorch reference of FF chapter training of DeepSeek-V3's block
as Moonlight-16B-A3B configures it (arXiv:2412.19437;
hf:moonshotai/Moonlight-16B-A3B), cut to one card's share of it.

Written from the layer equations, in float32 with TF32 off, one batch
row of attention at a time. Layer 0: multi-head latent attention, then
the SiLU-gated dense MLP; layers 1.. : MLA, then the MoE. Every layer is
pre-norm residual with ``(1 + scale)`` RMS norms.

- MLA (no q LoRA): q = x W_q split per head into q_nope and q_pe;
  [c, k_pe] = x W_kva, c = RMSNorm(c) (eps 1e-6); [k_nope, v] = c W_kvb;
  q_pe and k_pe (one head, shared) roped; q = [q_nope, q_pe], k =
  [k_nope, k_pe]; causal softmax(q k / sqrt(nope + rope)) v, then W_o.
- Router: s = sigmoid(x W_gate) in f32 over every expert; the choice is
  the top k of s + b (b the correction bias, no gradient); the weights
  are the chosen s over their sum (+ 1e-20) times the routed scale.
- MoE: the held experts' part, sum over the (token, slot) pairs whose
  expert is held of weight x expert(x), no pair dropped; pairs on the
  experts of other cards are left out; plus the shared experts.
- FF chapter training (arXiv:2404.08573): block k's grad step takes the
  tokens and their corruptions (``lm.corrupt``, drawn from ``lib.keys``)
  through the frozen blocks < k; the loss is softplus(theta - g) on the
  positives' positions and softplus(g - theta) on the negatives', g =
  mean((y - x)^2) of the block's residual update, plus alpha times the
  sequence-wise balance loss (eqs. 17-20: per sequence sum_i f_i P_i,
  f_i = E / (k S) x the tokens choosing i, P_i the mean of s_i / sum_j
  s_j; averaged over the sequences). Adam updates the weights, stored
  in the configuration's type; then the bias moves by gamma x sign(mean
  load - load_i), the loads counted over that forward's choices. The
  head step: the untied ``lm_head``'s cross-entropy over the
  vocabulary slice on the last layer's output under the final norm.

Routing is pinned: every router call takes the program's choices
(``choices``, one (T, k) tensor per call in call order), since scores
that are nearly tied flip between bf16 and f32; each call also counts
how many of those choices lie in its own top k (``agree``, ``n``).
With ``half_batch`` the rows are not the program's, and every call
takes its own choices.

Departures from the published description: the rope dimensions rotate
half-split where the checkpoints store them interleaved (with seeded
weights a fixed permutation of ``wq``'s and ``wkva``'s rope columns);
the norm scales are ``(1 + scale)``, zero at the start (a checkpoint's
weight w would load as w - 1); the layer holds experts
``[expert_offset, expert_offset + n_routed_experts)`` of
``router_experts`` and the vocabulary's first ``vocab_size`` rows (one
card's share of a deployment, the cut in ``configs/``); gamma and alpha
are DeepSeek-V3's, which Moonlight's config does not state. It imports
nothing of the program.

``precision="fp8"`` rounds every product's operands to float8 e4m3
under a per-tensor scale, and ``half_batch=True`` takes the loss over
the first half of the rows: the control and a planted fault, put in the
program's place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.lib import weights_mla_moe as wm
from portbench.lib.keys import Key
from portbench.reference.lm import (_ein, _softplus, _tf32_off, adam,
                                    attention, corrupt, rms_norm, rope)

KV_NORM_EPS = 1e-6


def mla(w, cfg, x, precision):
    """Causal MLA of x (B, S, d) -> (B, S, d); ``w`` one layer's leaves
    in float32."""
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    H, theta = cfg["num_attention_heads"], cfg["rope_theta"]
    q = _ein("bsd,dhk->bshk", x, w["wq"], precision)
    kva = _ein("bsd,dr->bsr", x, w["wkva"], precision)
    c = rms_norm(kva[..., :r], w["kv_norm"], KV_NORM_EPS)
    kv = _ein("bsr,rhk->bshk", c, w["wkvb"], precision)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k_pe = rope(kva[..., r:][:, :, None], theta).expand(-1, -1, H, -1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    o = attention(q, k, kv[..., nope:], precision)
    return _ein("bshk,hkd->bsd", o, w["wo"], precision)


def gated(x, wi, wg, wo, precision):
    """The SiLU-gated MLP of rows x (..., d)."""
    a = F.silu(_ein("...d,df->...f", x, wg, precision)) \
        * _ein("...d,df->...f", x, wi, precision)
    return _ein("...f,fd->...d", a, wo, precision)


class Routes:
    """The program's choices, one per router call in call order (or
    None: each call takes its own), and the count of them that the
    calls' own top k holds."""

    def __init__(self, choices):
        self.choices = None if choices is None else list(choices)
        self.agree = self.n = 0

    def take(self, own):
        if self.choices is None:
            chosen = own
        else:
            chosen = self.choices.pop(0).to(own.device)
        self.agree += int((chosen[..., None] == own[:, None, :]).any(-1)
                          .sum())
        self.n += chosen.numel()
        return chosen


def route(w, cfg, xf, routes, precision):
    """Tokens xf (T, d) -> (scores s (T, E), the choices (T, k), their
    weights (T, k))."""
    s = torch.sigmoid(_ein("td,de->te", xf, w["router"], precision))
    own = torch.topk(s + w["bias"].detach(), cfg["num_experts_per_tok"],
                     dim=-1).indices
    chosen = routes.take(own)
    wts = s.gather(1, chosen)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) \
        * cfg["routed_scaling_factor"]
    return s, chosen, wts


def moe(w, cfg, x, routes, precision):
    """x (B, S, d) f32 -> (the held experts' part plus the shared
    experts, the balance loss, the loads (E,))."""
    B, S, d = x.shape
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    e0, E_h = cfg["expert_offset"], cfg["n_routed_experts"]
    xf = x.reshape(-1, d)
    s, chosen, wts = route(w, cfg, xf, routes, precision)
    y = torch.zeros_like(xf)
    for e in range(E_h):
        t, slot = (chosen == e0 + e).nonzero(as_tuple=True)
        if not t.numel():
            continue
        out = gated(xf[t], w["wi"][e], w["wg"][e], w["wo_mlp"][e], precision)
        y = y.index_add(0, t, out * wts[t, slot][:, None])
    y = y + gated(xf, w["shared_wi"], w["shared_wg"], w["shared_wo"],
                  precision)
    one = torch.zeros_like(s).scatter_(1, chosen, 1.0)
    f = one.reshape(B, S, E).sum(1) * (E / (k * S))
    share = (s / s.sum(-1, keepdim=True)).reshape(B, S, E).mean(1)
    bal = (f * share).sum(-1).mean()
    return y.reshape(B, S, d), bal, one.sum(0)


def layer(w, cfg, j, x, routes, precision):
    """Layer ``j`` (0: the dense one): (x_out, balance loss, loads or
    None)."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(w, cfg, rms_norm(x, w["norm1"], eps), precision)
    h = rms_norm(x, w["norm2"], eps)
    if j == 0:
        return x + gated(h, w["wi"], w["wg"], w["wo_mlp"], precision), \
            0.0, None
    y, bal, loads = moe(w, cfg, h, routes, precision)
    return x + y, bal, loads


def unit(weights, j):
    return {n: t.float() for n, t in wm.unit(weights, j).items()}


@_tf32_off
def follow_blocks(weights, cfg, batches, seed, lr, choices, *,
                  precision="f32", half_batch=False):
    """Block k's grad step with global step number k + 1, for each of
    ``batches`` ((B, S + 1) token rows) in turn, from ``weights``
    (``lib.weights_mla_moe.make``'s; the layers it trains are copied),
    the router calls taking ``choices`` (None: their own). Returns
    {"loss": per step, "grad1": each block's gradient at its step,
    "params": the trained layers' leaves after the last step, "bias":
    their routers' biases, "agree", "n"}."""
    vocab, theta = cfg["vocab_size"], cfg["theta"]
    alpha, gamma = cfg["alpha"], cfg["gamma"]
    embed = weights["embed"].float()
    n = len(batches)
    layers = [{nm: t.clone() for nm, t in wm.unit(weights, j).items()}
              for j in range(n)]
    routes = Routes(None if half_batch else choices)
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
                x = layer({nm: t.float() for nm, t in layers[j].items()},
                          cfg, j, x, routes, precision)[0]
        leaves = {nm: t.detach().float().clone().requires_grad_() for nm, t in
                  layers[k].items()}
        with torch.enable_grad():
            y, bal, loads = layer(leaves, cfg, k, x, routes, precision)
            g = torch.mean((y - x) ** 2, dim=-1)
            per = torch.cat([_softplus(theta - g[:B]),
                             _softplus(g[B:] - theta)])
            loss = torch.mean(per) + alpha * bal
            names = [nm for nm in leaves if nm != "bias"]
            grads = torch.autograd.grad(loss, [leaves[nm] for nm in names])
        out["loss"].append(float(loss.detach()))
        for nm, gr in zip(names, grads):
            out["grad1"][f"{k}.{nm}"] = gr.detach().clone()
            adam(layers[k][nm], gr, torch.zeros_like(gr),
                 torch.zeros_like(gr), lr, step)
        if loads is not None:
            b = layers[k]["bias"]
            b.add_(gamma * torch.sign(loads.mean() - loads))
    out["params"] = {f"{j}.{nm}": layers[j][nm] for j in range(n)
                     for nm in wm.unit_leaves(j) if nm != "bias"}
    out["bias"] = {f"{j}.bias": layers[j]["bias"] for j in range(1, n)}
    out["agree"], out["n"] = routes.agree, routes.n
    return out


@_tf32_off
def head_step(state, cfg, tokens, choices, *, precision="f32",
              half_batch=False, chunk=2048):
    """The head step's loss and its gradient of ``final_norm`` and
    ``lm_head``, from ``state`` (every layer's weights, as
    ``lib.weights_mla_moe.make`` lays them out): the features of every
    layer without grad, then the CE over the slice in row chunks."""
    routes = Routes(None if half_batch else choices)
    if half_batch:
        tokens = tokens[:tokens.shape[0] // 2]
    inp, labels = tokens[:, :-1], tokens[:, 1:].reshape(-1).long()
    with torch.no_grad():
        x = F.embedding(inp.long(), state["embed"].float())
        for j in range(cfg["num_hidden_layers"]):
            x = layer(unit(state, j), cfg, j, x, routes, precision)[0]
    x = x.reshape(-1, x.shape[-1])
    fn = state["final_norm"].float().requires_grad_()
    head = state["lm_head"].float().requires_grad_()
    total = labels.numel()
    loss = 0.0
    g_fn, g_head = torch.zeros_like(fn), torch.zeros_like(head)
    for i in range(0, total, chunk):
        with torch.enable_grad():
            h = rms_norm(x[i:i + chunk], fn, cfg["rms_norm_eps"])
            logits = _ein("td,dv->tv", h, head, precision)
            part = F.cross_entropy(logits, labels[i:i + chunk],
                                   reduction="sum") / total
            a, b = torch.autograd.grad(part, (fn, head))
        g_fn += a
        g_head += b
        loss += float(part.detach())
    return {"loss": [loss], "grad1": {"final_norm": g_fn, "lm_head": g_head},
            "agree": routes.agree, "n": routes.n}
