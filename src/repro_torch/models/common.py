"""Shared numerics: norms, RoPE, initializers, activations (own copy of
``repro.models.common``). Every function keeps the reference's cast
points: compute in f32, cast back to the input's dtype."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import tree_stack


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rms_norm(x, scale, eps=1e-6):
    """``(1 + scale)``-scaled RMS norm in f32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rms_normalize(x, eps=1e-6):
    """Scale-free RMS normalization in f32, cast back to x's dtype (the
    FF goodness's locality)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def activation(name):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": torch.relu,
    }[name]


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` switches to the identity above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def softcap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_inv(head_dim, theta, device):
    """``rope_freqs`` on ``device``, copied there once: a copy from host
    memory at every call would wait for the card each time (twice per
    attention layer and decode step)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S) integer. Half-split (not
    interleaved) rotation in f32, cast back to x's dtype."""
    hd = x.shape[-1]
    inv = _rope_inv(hd, theta, x.device)
    ang = positions[..., None].float() * inv                   # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers: each takes an explicit torch.Generator and draws on its
# device (the reference's threefry bits cannot be reproduced; the tests
# hand the port the reference's own parameters instead)
# ---------------------------------------------------------------------------

def dense_init(gen, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    std = fan_in ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def zeros_init(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def stack_init(gen, repeat, init_fn):
    """``repeat`` draws of a parameter tree, stacked on axis 0."""
    return tree_stack([init_fn(gen) for _ in range(repeat)])
