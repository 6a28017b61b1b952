"""Dense gated MLP (own copy of ``repro.models.mlp``'s dense part).
``Dist``, ``NO_DIST`` and MoE wait for the pod and MoE slices
(``ROADMAP.md`` §1)."""
from __future__ import annotations

from repro_torch.models import common


def dense_mlp_init(gen, d_model, d_ff, dtype):
    return {
        "wi": common.dense_init(gen, (d_model, d_ff), dtype),
        "wg": common.dense_init(gen, (d_model, d_ff), dtype),
        "wo": common.dense_init(gen, (d_ff, d_model), dtype),
    }


def dense_mlp_apply(p, x, act_name="silu"):
    act = common.activation(act_name)
    h = act(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]
