"""Dense (gated) MLP and Mixture-of-Experts (own copy of
``repro.models.mlp``).

MoE routes each token to its top-k experts by a router in f32 and runs
the experts as batched GEMMs (``torch.bmm``: no kernel in either
package). Two branches, chosen from the token count T (a Python int):

  dense-local  ``T <= 64 * top_k`` (decode): every expert runs over
               every token, weighted by a scattered (T, E) gate matrix;
               the cost is reading every expert's weights.
  sorted       otherwise (prefill): MegaBlocks-style sort-based dispatch
               into a fixed per-expert capacity C; a token's choice past
               C (by stable sort order) is dropped.

Nothing on either branch reads a value back to the host. ``Dist`` exists
in its disabled form only, and nothing takes one yet: expert parallelism
(``all_to_all`` over a model axis) waits for the pod slice
(``ROADMAP.md`` §1).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models import common


# ---------------------------------------------------------------------------
# Distribution context (disabled only on one card)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dist:
    """Names of mesh axes; None disables explicit collectives. The port
    runs on one card: an enabled ``Dist`` (a mesh and a model axis)
    raises ``NotImplementedError`` until the pod slice."""
    mesh: object = None
    batch_axes: Tuple[str, ...] = ()     # axes sharding the batch/token dim
    model_axis: Optional[str] = None     # tensor/expert-parallel axis
    fsdp_axis: Optional[str] = None      # axis sharding expert d_model (ZeRO)

    def __post_init__(self):
        if self.enabled:
            raise NotImplementedError(
                "expert parallelism over a mesh is not ported yet; it waits "
                "for the pod slice (ROADMAP.md §1: the pod path)")

    @property
    def enabled(self):
        return self.mesh is not None and self.model_axis is not None


NO_DIST = Dist()


@contextlib.contextmanager
def full_f32():
    """f32 matmuls at full precision inside the block (TF32 off on the
    card whatever the caller set): the router's top-k must see the
    reference's logits."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_init(gen, moe, d_model, dtype):
    E, ff = moe.num_experts, moe.expert_ff
    p = {
        "router": common.dense_init(gen, (d_model, E), torch.float32),
        "wi": common.dense_init(gen, (E, d_model, ff), dtype,
                                fan_in=d_model),
        "wg": common.dense_init(gen, (E, d_model, ff), dtype,
                                fan_in=d_model),
        "wo": common.dense_init(gen, (E, ff, d_model), dtype, fan_in=ff),
    }
    if moe.num_shared:
        p["shared"] = dense_mlp_init(gen, d_model,
                                     moe.num_shared * moe.shared_ff, dtype)
    return p


def _capacity(tokens, top_k, num_experts, cf):
    c = int(tokens * top_k / num_experts * cf)
    return max(8, -(-c // 8) * 8)        # round up to multiple of 8


def _router(p, x, moe):
    """x: (T, d) -> gate (T, k) f32 renormalised, eids (T, k), and the
    switch-style load-balance loss over the first choice."""
    with full_f32():
        logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate, eids = torch.topk(probs, moe.top_k, dim=-1, sorted=True)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)                                 # (E,)
    experts = torch.arange(moe.num_experts, device=x.device)
    ce = (eids[:, :1] == experts).float().mean(dim=0)
    aux = moe.num_experts * torch.sum(me * ce)
    return gate, eids, aux


def _sorted_dispatch(x, eids, num_experts, capacity):
    """x: (T, d), eids: (T, k) -> buf (E, C, d), plus the combine's
    metadata (sort_idx, dest, valid) as the reference forms it.

    The (token, slot) pairs sort stably by expert; the i-th pair of
    expert e fills its row i while i < C. The buffer is gathered row by
    row from the pair that fills it (each row read once, no duplicate
    writes, so the result is deterministic); ``dest`` is ``E * C`` for a
    dropped pair."""
    T, d = x.shape
    k = eids.shape[1]
    dev = x.device
    flat_e = eids.reshape(-1)                              # (Tk,)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    experts = torch.arange(num_experts, device=dev)
    starts = torch.searchsorted(sorted_e, experts)         # (E,)
    ends = torch.searchsorted(sorted_e, experts, right=True)
    pos_in_e = torch.arange(T * k, device=dev) - starts[sorted_e]
    valid = pos_in_e < capacity
    dest = torch.where(valid, sorted_e * capacity + pos_in_e,
                       num_experts * capacity)             # overflow -> drop
    src = starts[:, None] + torch.arange(capacity, device=dev)   # (E, C)
    filled = src < ends[:, None]
    rows = x[sort_idx[torch.where(filled, src, 0)] // k]   # (E, C, d)
    buf = torch.where(filled[..., None], rows, 0)
    return buf, (sort_idx, dest, valid)


def _combine(buf_out, meta, T, k, gate):
    sort_idx, dest, valid = meta
    d = buf_out.shape[-1]
    flat = buf_out.reshape(-1, d)
    y_sorted = flat[torch.where(valid, dest, 0)]
    y_sorted = torch.where(valid[:, None], y_sorted, 0)
    inv = torch.argsort(sort_idx)
    y_tk = y_sorted[inv].reshape(T, k, d)
    with full_f32():
        y = torch.einsum("tkd,tk->td", y_tk.float(), gate)
    return y.to(buf_out.dtype)


def _expert_ffn(wi, wg, wo, tokens, act_name):
    """tokens: (E, C, d) -> (E, C, d), expert e's FFN on its rows."""
    act = common.activation(act_name)
    h = act(torch.bmm(tokens, wg)) * torch.bmm(tokens, wi)
    return torch.bmm(h, wo)


def _moe_local(p, x, moe, act_name):
    """x: (T, d) tokens -> (y (T, d), aux)."""
    T, d = x.shape
    gate, eids, aux = _router(p, x, moe)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if T <= 64 * moe.top_k:
        # dense-local experts: (T, E) gates, every expert over every token
        gates_full = torch.zeros((T, moe.num_experts), device=x.device
                                 ).scatter(1, eids, gate)
        h = _expert_ffn(wi, wg, wo, x.expand(moe.num_experts, T, d),
                        act_name)                          # (E, T, d)
        with full_f32():
            y = torch.einsum("etd,te->td", h.float(), gates_full)
        y = y.to(x.dtype)
    else:
        cap = _capacity(T, moe.top_k, moe.num_experts, moe.capacity_factor)
        buf, meta = _sorted_dispatch(x, eids, moe.num_experts, cap)
        y = _combine(_expert_ffn(wi, wg, wo, buf, act_name), meta, T,
                     moe.top_k, gate)
    if "shared" in p:
        y = y + dense_mlp_apply(p["shared"], x, act_name)
    return y, aux


def moe_apply(p, x, moe, act_name):
    """x: (B, S, d). Returns (y, aux_loss)."""
    d = x.shape[-1]
    y, aux = _moe_local(p, x.reshape(-1, d), moe, act_name)
    return y.reshape(x.shape), aux
