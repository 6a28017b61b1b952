"""Initial weights of the MLA + MoE cut from the seed, made on the
device in a few large calls, as ``lib/weights.py`` makes the dense
LM's: each matrix one ``randn`` in float32 scaled by fan_in^-1/2, cast
to the configuration's type; norm scales and the router's bias start at
zero, the router in float32.

``make(cfg, seed, device)`` returns ``{"embed" (V, d), "lm_head" (d,
V), "final_norm" (d,), "dense": {leaf: (1, ...)}, "moe": {leaf: (L-1,
...)}}``: the dense layer 0 and the MoE layers 1..L-1, every layer's
leaf stacked on axis 0. Leaves (``DENSE_LEAVES``, ``MOE_LEAVES``): the
norms, MLA's ``wq`` (d, H, nope + rope), ``wkva`` (d, r + rope),
``kv_norm`` (r,), ``wkvb`` (r, H, nope + dv), ``wo`` (H, dv, d); the
dense MLP's ``wi``, ``wg`` (d, ff), ``wo_mlp`` (ff, d); the MoE's
``router`` (d, E), ``bias`` (E,), the held experts' ``wi``, ``wg`` (E_h,
d, ff), ``wo_mlp`` (E_h, ff, d), the shared experts' ``shared_wi``,
``shared_wg`` (d, sf), ``shared_wo`` (sf, d).
"""
from __future__ import annotations

import torch

ATTN_LEAVES = ("norm1", "wq", "wkva", "kv_norm", "wkvb", "wo", "norm2")
DENSE_LEAVES = ATTN_LEAVES + ("wi", "wg", "wo_mlp")
MOE_LEAVES = ATTN_LEAVES + ("router", "bias", "wi", "wg", "wo_mlp",
                            "shared_wi", "shared_wg", "shared_wo")
F32_LEAVES = ("norm1", "norm2", "kv_norm", "router", "bias", "final_norm")


def unit_leaves(j):
    """The leaves of layer ``j`` (0: the dense one)."""
    return DENSE_LEAVES if j == 0 else MOE_LEAVES


def make(cfg, seed, device):
    """The weights for ``cfg``, the configuration file's keys (the
    published config's names: ``n_routed_experts`` the experts held
    here, ``router_experts`` the router's width)."""
    dt = getattr(torch, cfg["dtype"])
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    L = cfg["num_hidden_layers"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    E, E_h = cfg["router_experts"], cfg["n_routed_experts"]
    ff = cfg["moe_intermediate_size"]
    sf = ff * cfg["n_shared_experts"]
    V = -(-cfg["vocab_size"] // 128) * 128
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, fan_in, dtype=dt):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def z(*shape):
        return torch.zeros(shape, device=device)

    def attn(n):
        return {"norm1": z(n, d), "wq": normal((n, d, H, nope + rope), d),
                "wkva": normal((n, d, r + rope), d), "kv_norm": z(n, r),
                "wkvb": normal((n, r, H, nope + dv), r),
                "wo": normal((n, H, dv, d), H * dv), "norm2": z(n, d)}

    out = {"embed": normal((V, d), d), "lm_head": normal((d, V), d),
           "final_norm": z(d)}
    fd = cfg["intermediate_size"]
    out["dense"] = {**attn(1), "wi": normal((1, d, fd), d),
                    "wg": normal((1, d, fd), d),
                    "wo_mlp": normal((1, fd, d), fd)}
    n = L - 1
    out["moe"] = {**attn(n), "router": normal((n, d, E), d, torch.float32),
                  "bias": z(n, E), "wi": normal((n, E_h, d, ff), d),
                  "wg": normal((n, E_h, d, ff), d),
                  "wo_mlp": normal((n, E_h, ff, d), ff),
                  "shared_wi": normal((n, d, sf), d),
                  "shared_wg": normal((n, d, sf), d),
                  "shared_wo": normal((n, sf, d), sf)}
    return out


def unit(w, j):
    """Layer ``j``'s leaves (views)."""
    return ({n: t[0] for n, t in w["dense"].items()} if j == 0
            else {n: t[j - 1] for n, t in w["moe"].items()})
