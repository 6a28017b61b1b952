"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
own copy of ``repro.models.rglru``).

    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block: y = out_proj( gelu(gate_branch) * RG-LRU(conv1d(x_branch)) ).

The reference has no Pallas kernel for the RG-LRU, so there is no CUDA
kernel here either: the whole block is plain torch on every device.
Prefill runs the linear recurrence as a log-depth (Hillis-Steele) scan
over the sequence, ceil(log2 S) steps of elementwise ops, where the
reference uses ``jax.lax.associative_scan``; the two sum in different
orders, so they agree to f32 rounding, not bit for bit. Decode is the
single-step recurrence, written into the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.ssm import _causal_conv

_C = 8.0
_gelu = common.activation("gelu")      # the tanh form, as jax.nn.gelu's


def _width(cfg):
    return cfg.rglru.lru_width or cfg.d_model


def init(gen, cfg):
    g = cfg.rglru
    d = cfg.d_model
    W = _width(cfg)
    dev = gen.device
    dtype = common.dtype_of(cfg)
    x_branch = common.dense_init(gen, (d, W), dtype)
    gate_branch = common.dense_init(gen, (d, W), dtype)
    conv_w = (torch.randn((g.conv_width, W), generator=gen, device=dev)
              * 0.1).to(dtype)
    w_a = common.dense_init(gen, (W, W), dtype)
    # Lambda init so that a^c in [0.9, 0.999] (Griffin appendix)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = lo + (hi - lo) * torch.rand((W,), generator=gen, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))   # inv softplus
    return {
        "x_branch": x_branch,
        "gate_branch": gate_branch,
        "conv_w": conv_w,
        "w_a": w_a,
        "w_x": common.dense_init(gen, (W, W), dtype),
        "lambda": lam,
        "out_proj": common.dense_init(gen, (W, d), dtype),
    }


def _gates(p, x):
    """(a, b) of the recurrence h = a h + b, both f32."""
    r = torch.sigmoid((x @ p["w_a"]).float())
    i = torch.sigmoid((x @ p["w_x"]).float())
    log_a = -_C * common.softplus(p["lambda"]) * r     # (..., W), <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * x.float()


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, for every t:
    Hillis-Steele over the pairs (a, b), where (a1, b1) then (a2, b2)
    compose to (a2 a1, a2 b1 + b2). ceil(log2 S) steps, none in place
    (autograd differentiates it)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def forward(p, cfg, x, h0=None, conv0=None):
    """x: (B, S, d) -> (y (B, S, d), h_T (B, W) f32, conv_tail (B, cw-1,
    W)): the state after the last token and the raw (pre-conv) inputs
    the next conv needs, as ``decode_step`` takes them (copies, so that
    a cache does not hold the whole sequence's tensors)."""
    g = cfg.rglru
    xb = x @ p["x_branch"]
    gate = x @ p["gate_branch"]
    if conv0 is not None:
        ext = torch.cat([conv0, xb], dim=1)
        xb = _causal_conv(ext, p["conv_w"])[:, conv0.shape[1]:]
        conv_tail = ext[:, -(g.conv_width - 1):]
    else:
        conv_tail = xb[:, -(g.conv_width - 1):]     # raw (pre-conv) tail
        xb = _causal_conv(xb, p["conv_w"])
    a, b = _gates(p, xb)                               # (B, S, W) f32
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    hh = linear_scan(a, b)
    y = hh.to(x.dtype) * _gelu(gate.float()).to(x.dtype)
    return y @ p["out_proj"], hh[:, -1].clone(), conv_tail.clone()


def init_cache(cfg, batch, dtype, device):
    g = cfg.rglru
    W = _width(cfg)
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, g.conv_width - 1, W), dtype=dtype,
                            device=device),
    }


def decode_step(p, cfg, cache, x):
    """x: (B, d) one token. Returns (y (B, d), cache), the cache's ``h``
    and ``conv`` updated in place (they are views into the stacked
    caches, which ``transformer.serve_step`` keeps)."""
    xb = x @ p["x_branch"]
    gate = x @ p["gate_branch"]
    conv_in = torch.cat([cache["conv"], xb[:, None]], dim=1)
    xb = torch.einsum("bwc,wc->bc", conv_in.float(),
                      p["conv_w"].float()).to(x.dtype)
    a, b = _gates(p, xb)
    h = a * cache["h"] + b
    y = h.to(x.dtype) * _gelu(gate.float()).to(x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_in[:, 1:])
    return y @ p["out_proj"], cache
