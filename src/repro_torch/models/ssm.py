"""Mamba-2 SSD (state-space duality) block, chunked algorithm
[arXiv:2405.21060], n_groups=1 (own copy of ``repro.models.ssm``).

Prefill: the chunked dual form through the kernel op
``ops.mamba2_ssd`` (the hand-written CUDA kernel on the card, the plain
chunked form on the CPU), carrying the (H, hd, N) state across chunks.
Decode: the O(1) recurrent update, plain torch, in place on the cache.

The reference's ``forward`` also takes an initial state ``h0`` and conv
tail ``conv0``; nothing in the reference passes them, so they are left
out here until a slice needs them (with an initial-state input to the
kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.mamba2_ssd import mamba2_ssd_plain
from repro_torch.models import common
from repro_torch.models.mlp import NO_DIST


def init(gen, cfg):
    """Single fused input projection (z | x | b | c | dt), as in the
    reference Mamba-2."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    N = s.state_dim
    dev = gen.device
    dtype = common.dtype_of(cfg)
    in_proj = common.dense_init(gen, (d, 2 * d_inner + 2 * N + H), dtype)
    conv_w = (torch.randn((s.conv_width, d_inner + 2 * N), generator=gen,
                          device=dev) * 0.1).to(dtype)
    u = torch.rand((H,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "A_log": torch.zeros((H,), device=dev),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.log(torch.expm1(dt)),     # inverse softplus
        "norm": torch.zeros((d_inner,), device=dev),
        "out_proj": common.dense_init(gen, (d_inner, d), dtype),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (cw, C). f32 sums, cast
    back to x's dtype."""
    cw = w.shape[0]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(cw):
        out = out + pad[:, i:i + x.shape[1], :].float() * w[i]
    return out.to(x.dtype)


def _proj_inputs(p, cfg, x):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    N = s.state_dim
    zxbcdt = x @ p["in_proj"]
    return torch.split(
        zxbcdt, [d_inner, d_inner, N, N, zxbcdt.shape[-1] - 2 * d_inner - 2 * N],
        dim=-1)


def ssd_chunked(xh, dt, A, b, c, chunk):
    """The plain chunked SSD scan (the reference's ``ssd_chunked``).

    xh: (B, S, H, hd); dt: (B, S, H) post-softplus; A: (H,) negative;
    b, c: (B, S, N). Returns y: (B, S, H, hd) and the final state
    (B, H, hd, N), both f32.
    """
    dA = dt.float() * A
    xbar = xh.float() * dt.float()[..., None]
    return mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk)


def forward(p, cfg, x, return_cache=False, impl="auto"):
    """Full-sequence forward. x: (B, S, d) -> (B, S, d).

    With ``return_cache`` also returns {"h": final state, "conv": raw
    pre-conv tail} ready for ``decode_step``: the whole state, which
    ``blocks.block_prefill`` cuts to the rank's slice under a ``Dist``
    (``blocks.cache_block``).
    """
    s = cfg.ssm
    B, S, d = x.shape
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    z, xin, b, c, dt_raw = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xin, b, c], dim=-1)
    conv_tail = xbc[:, -(s.conv_width - 1):]       # raw (pre-conv) tail
    xbc = _causal_conv(xbc, p["conv_w"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xin, b, c = torch.split(xbc, [d_inner, s.state_dim, s.state_dim], dim=-1)

    dt = common.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, H, s.head_dim)
    # dA and xbar in f32, as ssd_chunked forms them; the op masks (kernel)
    # or pads (plain) a ragged last chunk with inert dt = 0 rows
    dA = (dt * A).contiguous()
    xbar = (xh.float() * dt[..., None]).contiguous()
    y, hT = ops.mamba2_ssd(xbar, dA, b.float().contiguous(),
                           c.float().contiguous(), chunk=s.chunk, impl=impl)
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z.float())
    y = common.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_cache:
        return out, {"h": hT, "conv": conv_tail}
    return out


def init_cache(cfg, batch, dtype, device):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1,
                             d_inner + 2 * s.state_dim), dtype=dtype,
                            device=device),
    }


def _state_block(cfg, h):
    """Which block of the (B, H, hd, N) state the cache leaf ``h``
    holds: (heads, head dims) slices and the dim of y (B, H, hd) split
    over "model" (1: H, 2: hd), or None where it is whole."""
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.head_dim
    if h.shape[1] != H:
        return 1, h.shape[1]
    if h.shape[2] != s.head_dim:
        return 2, h.shape[2]
    return None


def decode_step(p, cfg, cache, x, dist=NO_DIST):
    """x: (B, d) single token. Returns (y (B, d), cache), the cache's
    ``h`` and ``conv`` updated in place. Under a ``Dist`` whose caches
    split ``h`` over "model" (``cache_specs_tree``: hd, or H at batch
    1), the projections and conv run as ever on the gathered leaves, the
    rank updates its slice of the state, and its slice of y is gathered
    over "model" before the gated norm."""
    s = cfg.ssm
    B, d = x.shape
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    z, xin, b, c, dt_raw = _proj_inputs(p, cfg, x)
    xbc = torch.cat([xin, b, c], dim=-1)                      # (B, C)
    conv_in = torch.cat([cache["conv"], xbc[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", conv_in.float(),
                            p["conv_w"].float())
    xbc = F.silu(conv_out).to(x.dtype)
    xin, b, c = torch.split(xbc, [d_inner, s.state_dim, s.state_dim], dim=-1)

    dt = common.softplus(dt_raw.float() + p["dt_bias"])       # (B, H)
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, H, s.head_dim).float()
    Dh = p["D"]
    split = _state_block(cfg, cache["h"])
    if split is not None:
        dim, n = split
        first = sharding.axis_index(dist.mesh, dist.model_axis) * n
        xh = xh.narrow(dim, first, n)
        if dim == 1:
            dt, A, Dh = dt[:, first:first + n], A[first:first + n], \
                Dh[first:first + n]
    dA = torch.exp(dt * A)                                    # (B, H)
    h = cache["h"] * dA[..., None, None] + torch.einsum(
        "bh,bhd,bn->bhdn", dt, xh, b.float())
    y = torch.einsum("bn,bhdn->bhd", c.float(), h)
    y = y + Dh[:, None] * xh
    if split is not None:
        y = sharding.all_gather(y, dist.mesh, dist.model_axis, split[0])
    y = y.reshape(B, d_inner) * F.silu(z.float())
    y = common.rms_norm(y.to(x.dtype), p["norm"], cfg.norm_eps)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_in[:, 1:])
    return y @ p["out_proj"], cache
