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

Nothing on either branch reads a value back to the host.

DeepSeek-V3's MoE (``configs.SigmoidMoEConfig``: the ``mla_moe``
block's) routes by sigmoid scores plus a correction bias
(``sigmoid_router``), keeps every choice, and holds a contiguous share
of the experts (``sigmoid_moe_apply``): the (token, slot) pairs that
land on a held expert sort into one segment per expert, each expert's
gated MLP runs on its segment alone (grouped GEMMs, ``torch._grouped_mm``,
over segment ends that stay on the device: no capacity, no padding, no
read back), and the rest are left out, for the cards that hold them.

Expert parallelism (``Dist`` enabled: a mesh and a model axis): each
rank runs the body on its own batch shard of the tokens, with the
experts split over the model axis and the expert weights' d_model over
the fsdp axis (ZeRO), as the reference's ``shard_map`` body does:
the weights are all-gathered over the fsdp axis; the dense-local branch
runs the rank's experts over every token and sums over the model axis;
the sorted branch sends each expert's capacity rows to the rank that
holds it and back (``all_to_all_single``); the shared experts run
tensor-parallel (their ff split over the model axis, summed); the
router's aux loss is averaged over the batch axes. The body is
differentiable: each collective carries its transpose
(``sharding.py``), and the ranks of the model axis, which hold the same
tokens, split the work between them as the reference's transpose
does: the tokens and the gates enter the per-rank work through
``sharding.pvary`` (their cotangents summed over the model axis) and
the sorted branch's returned rows through ``sharding.pmean_equal``
(each rank's copy of a token counted once over the axis). The expert
grads come back summed over the fsdp axis; a replicated leaf's grad is
the rank's part, which the caller sums over the batch axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.models import common
from repro_torch.models.attention import _trace_backward
from repro_torch.obs import trace as obs_trace


# ---------------------------------------------------------------------------
# Distribution context threaded through the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Dist:
    """Names of mesh axes (a ``DeviceMesh``'s); None disables explicit
    collectives (one process)."""
    mesh: object = None
    batch_axes: Tuple[str, ...] = ()     # axes sharding the batch/token dim
    model_axis: Optional[str] = None     # tensor/expert-parallel axis
    fsdp_axis: Optional[str] = None      # axis sharding expert d_model (ZeRO)

    @property
    def enabled(self):
        return self.mesh is not None and self.model_axis is not None

    def model_size(self):
        return (sharding.axis_size(self.mesh, self.model_axis)
                if self.enabled else 1)

    def constrain_batch(self, x):
        """The identity. The reference pins an activation's batch dim to
        the data axes so GSPMD keeps it sharded; here no compiler
        reshards anything, and each rank already holds its batch shard."""
        return x


NO_DIST = Dist()


def model_split(dist):
    """Whether "model" splits work under ``dist``: an axis of more than
    one rank that is not a batch axis (its ranks then hold the same
    tokens, and a leaf or cache split over it stays split where it is
    used)."""
    return dist.model_size() > 1 and dist.model_axis not in dist.batch_axes


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


def dense_mlp_apply(p, x, act_name="silu", dist=NO_DIST):
    """The gated MLP. With ``dist`` enabled, p holds the rank's slice of
    ff (the column-parallel ``wi``/``wg``, the row-parallel ``wo``): x
    enters through ``pvary`` and the ranks' outputs are summed over the
    model axis (``psum``), as the shared experts run."""
    if dist.enabled:
        x = sharding.pvary(x, dist.mesh, dist.model_axis)
    act = common.activation(act_name)
    h = act(x @ p["wg"]) * (x @ p["wi"])
    y = h @ p["wo"]
    if dist.enabled:
        y = sharding.psum(y, dist.mesh, dist.model_axis)
    return y


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


def _moe_local(p, x, moe, act_name, dist=NO_DIST):
    """x: (T, d) tokens -> (y (T, d), aux). With ``dist`` enabled, x is
    this rank's token shard and p holds its shards: wi/wg (E_local,
    d_local, ff), wo (E_local, ff, d_local), the shared experts' ff
    slice."""
    T, d = x.shape
    mesh, ma, fa = dist.mesh, dist.model_axis, dist.fsdp_axis
    if dist.enabled and ma in dist.batch_axes:
        raise ValueError(
            "the MoE splits its experts over the model axis, so its tokens "
            "cannot be split over that axis too (batch_fold_model is for "
            "dense configs)")
    gate, eids, aux = _router(p, x, moe)
    # the model axis's ranks hold the same tokens and gates: the per-rank
    # work below reads them through pvary
    vary = ((lambda t: sharding.pvary(t, mesh, ma)) if dist.enabled
            else (lambda t: t))
    xv = vary(x)
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if dist.enabled and fa is not None:
        wi = sharding.all_gather(wi, mesh, fa, dim=1)
        wg = sharding.all_gather(wg, mesh, fa, dim=1)
        wo = sharding.all_gather(wo, mesh, fa, dim=2)
    if T <= 64 * moe.top_k:
        # dense-local experts: (T, E_local) gates of this rank's experts,
        # each over every token
        e_l = wi.shape[0]
        shard = sharding.axis_index(mesh, ma) if dist.enabled else 0
        gates_full = torch.zeros((T, moe.num_experts), device=x.device
                                 ).scatter(1, eids, gate)
        gates = vary(gates_full)[:, shard * e_l:(shard + 1) * e_l]
        h = _expert_ffn(wi, wg, wo, xv.expand(e_l, T, d),
                        act_name)                          # (E_l, T, d)
        with full_f32():
            y = torch.einsum("etd,te->td", h.float(), gates)
        if dist.enabled:
            y = sharding.psum(y, mesh, ma)
        y = y.to(x.dtype)
    else:
        cap = _capacity(T, moe.top_k, moe.num_experts, moe.capacity_factor)
        buf, meta = _sorted_dispatch(xv, eids, moe.num_experts, cap)
        if dist.enabled:
            # each expert's rows to the rank holding it: (n_model, E_l,
            # C, d), leading dim the destination, then the source
            n_model = dist.model_size()
            e_l = moe.num_experts // n_model
            buf = sharding.all_to_all(buf.reshape(n_model, e_l, cap, d),
                                      mesh, ma)
            tokens = buf.transpose(0, 1).reshape(e_l, n_model * cap, d)
            out = _expert_ffn(wi, wg, wo, tokens, act_name)
            out = out.reshape(e_l, n_model, cap, d).transpose(0, 1)
            # every rank of the model axis gets the same rows back
            buf_out = sharding.pmean_equal(
                sharding.all_to_all(out, mesh, ma), mesh, ma).reshape(
                moe.num_experts, cap, d)
        else:
            buf_out = _expert_ffn(wi, wg, wo, buf, act_name)
        y = _combine(buf_out, meta, T, moe.top_k, gate)
    if "shared" in p:
        # the shared experts run tensor-parallel: ff split on the model axis
        ys = dense_mlp_apply(p["shared"], xv, act_name)
        if dist.enabled:
            ys = sharding.psum(ys, mesh, ma)
        y = y + ys
    if dist.enabled:
        for axis in dist.batch_axes:
            aux = sharding.pmean(aux, mesh, axis)
    return y, aux


def moe_specs(p, dist):
    """The specs of the MoE's params under ``dist`` (the reference's
    ``moe_apply`` in_specs): experts on the model axis, their d_model on
    the fsdp axis, the shared experts' ff on the model axis."""
    ma, fa = dist.model_axis, dist.fsdp_axis
    specs = {"router": (None, None), "wi": (ma, fa, None),
             "wg": (ma, fa, None), "wo": (ma, None, fa)}
    if "shared" in p:
        specs["shared"] = {"wi": (None, ma), "wg": (None, ma),
                           "wo": (ma, None)}
    return specs


def moe_apply(p, x, moe, act_name, dist=NO_DIST):
    """x: (B, S, d): the whole batch, or with ``dist`` enabled this
    rank's batch shard, p the full params (each rank takes its shards) or
    the rank's shards already (``moe_specs``). Returns (y, aux_loss) for
    x's tokens; aux averaged over the batch axes."""
    d = x.shape[-1]
    if dist.enabled and tuple(p["wi"].shape[:2]) == (moe.num_experts, d):
        specs = moe_specs(p, dist)
        p = {k: ({kk: sharding.local_shard(vv, specs[k][kk], dist.mesh)
                  for kk, vv in v.items()} if isinstance(v, dict)
                 else sharding.local_shard(v, specs[k], dist.mesh))
             for k, v in p.items()}
    y, aux = _moe_local(p, x.reshape(-1, d), moe, act_name, dist)
    return y.reshape(x.shape), aux


# ---------------------------------------------------------------------------
# DeepSeek-V3's MoE: sigmoid router, no dropped choice, held experts
# ---------------------------------------------------------------------------

def sigmoid_moe_init(gen, moe, d_model, dtype):
    """The router over every expert (f32) and its correction bias (f32,
    zero, no gradient), the held experts' weights, the shared
    experts."""
    E_h, ff = moe.held, moe.expert_ff
    dev = gen.device
    p = {
        "router": common.dense_init(gen, (d_model, moe.num_experts),
                                    torch.float32),
        "bias": torch.zeros((moe.num_experts,), device=dev),
        "wi": common.dense_init(gen, (E_h, d_model, ff), dtype,
                                fan_in=d_model),
        "wg": common.dense_init(gen, (E_h, d_model, ff), dtype,
                                fan_in=d_model),
        "wo": common.dense_init(gen, (E_h, ff, d_model), dtype, fan_in=ff),
    }
    if moe.num_shared:
        p["shared"] = dense_mlp_init(gen, d_model,
                                     moe.num_shared * moe.shared_ff, dtype)
    return p


def sigmoid_router(p, x, moe, seqs):
    """x: (T, d), the tokens of ``seqs`` sequences of equal length, ->
    (weights (T, k) f32, eids (T, k), the sequence-wise balance loss,
    loads (E,) f32: each expert's choices among the T tokens).

    s = sigmoid(x W) in f32 over all E experts; the choice is the top k
    of s + bias (the bias only chooses); the weights are the chosen s
    over their sum (+ 1e-20), times ``routed_scale``. The balance loss
    (arXiv:2412.19437 eqs. 17-20) is, per sequence of S tokens,
    sum_i f_i P_i with f_i = E / (k S) x the tokens choosing i and P_i
    the mean over the tokens of s_i / sum_j s_j; then averaged over the
    sequences."""
    with full_f32():
        logits = x.float() @ p["router"]
    s = torch.sigmoid(logits)
    eids = torch.topk(s + p["bias"].detach(), moe.top_k, dim=-1,
                      sorted=True).indices
    w = s.gather(1, eids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * moe.routed_scale
    T, E = s.shape
    S = T // seqs
    chosen = torch.zeros_like(s).scatter_(1, eids, 1.0)
    f = chosen.reshape(seqs, S, E).sum(1) * (E / (moe.top_k * S))
    share = (s / s.sum(-1, keepdim=True)).reshape(seqs, S, E).mean(1)
    bal = (f * share).sum(-1).mean()
    return w, eids, bal, chosen.sum(0)


def _held_pairs(eids, moe):
    """Every (token, slot) pair, flattened and sorted by expert (stably)
    with the pairs on held experts first, and where each held expert's
    segment of them ends (int32, the grouped GEMMs' offsets). Nothing is
    read back to the host."""
    E_h = moe.held
    local = eids.reshape(-1) - moe.expert_offset
    key = torch.where((local >= 0) & (local < E_h), local, E_h)
    order = torch.argsort(key, stable=True)
    sizes = torch.zeros(E_h + 1, dtype=torch.int32, device=key.device)
    sizes.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return order, torch.cumsum(sizes[:E_h], 0, dtype=torch.int32)


def sigmoid_moe_apply(p, x, moe, act_name):
    """x: (B, S, d) -> (y (B, S, d), the balance loss, loads (E,)). y is
    the held experts' part, each (token, slot) pair on a held expert
    weighed by its router weight, plus the shared experts whole.

    The sorted pairs past the held experts' segments keep their rows
    through the dispatch (the shapes stay fixed, so nothing is read
    back), but no GEMM computes them: they are zeroed on the way in and
    out (``torch.where``, which zeroes their gradient too).

    Spans (``obs.trace.active()``): ``moe.router``, ``moe.dispatch``
    (the sort, the segment ends, the rows' gather), ``moe.experts``,
    ``moe.combine``, ``moe.shared`` and, under autograd, ``moe.bwd``
    between two autograd hooks; counters ``moe.choices`` (T k),
    ``moe.pairs`` (the router's choices on held experts, counted apart
    from the dispatch), ``moe.rows`` (the rows the expert GEMMs took:
    fewer than the pairs if one was dropped, more if padded) and
    ``moe.max_load`` (the largest held expert's rows, summed over
    calls); the last three are counted on the device."""
    B, S, d = x.shape
    x = x.reshape(-1, d)
    T, k = x.shape[0], moe.top_k
    dev = x.device
    tr = obs_trace.active()
    with tr.span("moe.router", device=dev):
        w, eids, bal, loads = sigmoid_router(p, x, moe, B)
    with tr.span("moe.dispatch", device=dev):
        order, ends = _held_pairs(eids, moe)
        kept = (torch.arange(T * k, device=dev) < ends[-1])[:, None]
        rows = torch.where(kept, x[order // k], 0)
    with tr.span("moe.experts", device=dev):
        # segment e of the rows times expert e's weights; the grouped
        # GEMMs leave the rows past ends[-1] unwritten
        act = common.activation(act_name)
        h = act(torch._grouped_mm(rows, p["wg"], offs=ends)) \
            * torch._grouped_mm(rows, p["wi"], offs=ends)
        ys = torch.where(kept, torch._grouped_mm(h, p["wo"], offs=ends), 0)
    with tr.span("moe.combine", device=dev):
        y_tk = torch.empty_like(ys).index_copy(0, order, ys)
        with full_f32():
            y = torch.einsum("tkd,tk->td", y_tk.reshape(T, k, d).float(), w)
        y = y.to(x.dtype)
    if "shared" in p:
        with tr.span("moe.shared", device=dev):
            y = y + dense_mlp_apply(p["shared"], x, act_name)
    if tr.enabled:
        tr.counter("moe.choices", T * k)
        off = moe.expert_offset
        tr.counter("moe.pairs",
                   ((eids >= off) & (eids < off + moe.held)).sum())
        tr.counter("moe.rows", ends[-1].long())
        tr.counter("moe.max_load", torch.diff(ends, prepend=ends[:1] * 0)
                   .max().long())
        if torch.is_grad_enabled() and y.requires_grad:
            # x's gradient is whole once every part of the layer has
            # run its backward, the weights' with it
            _trace_backward(tr, y, (x,), "moe.bwd")
    return y.reshape(B, S, d), bal, loads


def update_bias(bias, loads, rate):
    """The router's correction bias after a grad step, in place: b_i +=
    rate x sign(mean load - load_i) (arXiv:2412.19437 §2.1.2)."""
    with torch.no_grad():
        bias.add_(rate * torch.sign(loads.mean() - loads))
