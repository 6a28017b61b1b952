"""Initial weights from the seed, made on the device in a few large calls.

Both sides take these same tensors: the driver hands them to the program
in its tree layout, and the reference makes them again from the seed (a
``torch.Generator`` on the device draws the same numbers for the same
calls). Each matrix is one ``randn`` in float32, scaled by fan_in^-1/2 as
the program's own initializers scale it, then cast to the type it is
trained in; biases and norm scales start at zero.
"""
from __future__ import annotations

import torch


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _normal(gen, shape, fan_in, dtype, device):
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w * fan_in ** -0.5).to(dtype)


def ff_mlp(sizes, seed, device):
    """[{"w": (K, N), "b": (N,)}] float32 for the layers of ``sizes``."""
    gen = _gen(seed, device)
    return [{"w": _normal(gen, (k, n), k, torch.float32, device),
             "b": torch.zeros(n, device=device)}
            for k, n in zip(sizes[:-1], sizes[1:])]


def lm(cfg, seed, device):
    """A dense GQA transformer's weights, every block's leaf stacked on
    axis 0: {"embed", "final_norm", "norm1", "norm2", "wq", "bq", "wk",
    "bk", "wv", "bv", "wo", "wi", "wg", "wo_mlp"}, matrices in
    ``cfg["dtype"]``, norm scales in float32."""
    dt = getattr(torch, cfg["dtype"])
    L, d, H, KV = cfg["num_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv"]
    hd, ff = cfg["head_dim"], cfg["d_ff"]
    vp = -(-cfg["vocab"] // 128) * 128
    gen = _gen(seed, device)

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "embed": _normal(gen, (vp, d), d, dt, device),
        "final_norm": z(d, dtype=torch.float32),
        "norm1": z(L, d, dtype=torch.float32),
        "norm2": z(L, d, dtype=torch.float32),
        "wq": _normal(gen, (L, d, H, hd), d, dt, device),
        "bq": z(L, H, hd),
        "wk": _normal(gen, (L, d, KV, hd), d, dt, device),
        "bk": z(L, KV, hd),
        "wv": _normal(gen, (L, d, KV, hd), d, dt, device),
        "bv": z(L, KV, hd),
        "wo": _normal(gen, (L, H, hd, d), H * hd, dt, device),
        "wi": _normal(gen, (L, d, ff), d, dt, device),
        "wg": _normal(gen, (L, d, ff), d, dt, device),
        "wo_mlp": _normal(gen, (L, ff, d), ff, dt, device),
    }
