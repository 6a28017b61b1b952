"""PFF over a stage axis: the paper's pipeline on ``torch.distributed``
(the port of ``repro.core.pff_pod``, beyond-paper).

The paper pipelines FF layer-training across socket-connected nodes. On
a mesh the same idea maps onto a ``stage`` axis: each stage owns a
contiguous block range of the one stacked group, and within a stage the
batch splits over a ``data`` axis. Because FF has no backward pass, the
traffic between stages is ONE forward activation tensor per step, sent
to the next stage (``batch_isend_irecv``); nothing flows back:

  stage 0: blocks [0, R/P)   trains on step t's fresh embeddings
  stage 1: blocks [R/P, ..)  trains on stage 0's output of step t - 1
                             (the register it received, zeros at step 1)

Each process is one (stage, data) rank of the mesh and runs the per-rank
body the reference runs inside ``shard_map``: it holds its stage's rows
``[s*R/P, (s+1)*R/P)`` of the group, their Adam ``m``/``v``, and
``embed``. Every rank draws the step's negatives (``key_fn(seed)
.fold_in(step)``, ``ff.corrupt_tokens``), stacks ``[pos; neg]``, looks
up the embeddings and takes its data slice of the 2B rows. Each unit of
its rows is one local FF update, the same math as ``core.train``'s joint
step: the blocks under autograd on the plain route, the unit's loss
``ff_loss_masked(mean_goodness(y - h)) + 0.01 * moe_aux``, its grads
averaged over the data axis before that unit's Adam step (each data
shard sees a different slice of the stacked batch: the first shards all
positive, the last all negative, so without the average the replicas
diverge), the next unit fed the pre-update ``y``, detached.

The loss is the units' losses, each averaged over data, summed over the
stage's units and then over the stages. Sums and means of the loss
scalars gather the ranks' values and reduce them in rank order; the
grads' mean is an ``all_reduce`` sum divided by the data size, in each
grad's dtype, as ``pmean`` computes it (exact for two ranks in any
order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import optim, sharding
from repro_torch.convert import tree_map
from repro_torch.core import ff
from repro_torch.core.rng import TorchKey
from repro_torch.core.train import (AUX_WEIGHT, REF, adam_leaves, grads_of,
                                    trainable, unit_views)
from repro_torch.models import blocks, common

# the blocks' ctx under autograd: the plain route for attention too, as
# the reference's pod path reaches no kernel
_CTX = {**REF, "attn_impl": "ref"}


def stage_rows(tree, mesh):
    """This rank's stage rows of a stacked group tree, copied: nothing
    keeps the whole group's storage alive once the caller drops it."""
    return tree_map(
        lambda t: sharding.local_shard(t, ("stage",), mesh).clone(), tree)


def init_opt_state(params):
    """Adam ``m``/``v`` (f32) for this rank's stage rows only: the step
    trains nothing else."""
    return optim.adam_init({"groups": params["groups"]})


def gather_stage_rows(tree, mesh):
    """The whole stacked group from every stage's rows (rank order)."""
    return tree_map(lambda t: sharding.all_gather(t, mesh, "stage"), tree)


def _reduce_scalar(x, mesh, axis, op):
    """``op`` ("sum" or "mean") of a 0-d tensor over ``axis``: the
    ranks' values gathered, reduced in rank order."""
    vals = sharding.all_gather(x.reshape(1), mesh, axis)
    return vals.sum() if op == "sum" else vals.mean()


def make_pff_pod_step(cfg, mesh, *, lr=1e-3, seed=0, theta=None,
                      key_fn=TorchKey):
    """Returns step_fn(params, opt_state, batch, inflight, step) ->
    (params, opt_state, inflight, {"loss_ff"}) for a mesh with axes
    ("stage", "data", "model"), or ``mesh=None`` for one process without
    a group (one stage, one data shard).

    params: this rank's tree: ``groups`` holds its stage's rows of the
    single group (``stage_rows``), the rest as initialized; opt_state:
    ``init_opt_state(params)``; both updated in place. batch:
    {"tokens": (B, S+1)}, the whole batch on every rank. inflight: this
    rank's pipeline register (``init_inflight``). step: 1-based.

    Restriction (the reference's): cfg must be one uniform stacked group
    whose repeat the stage count divides.
    """
    assert len(cfg.groups) == 1, "pod-pipeline needs a uniform stack"
    pattern, repeat = cfg.groups[0]
    stages = sharding.axis_size(mesh, "stage")
    assert repeat % stages == 0, (repeat, stages)
    n_data = sharding.axis_size(mesh, "data")
    sid = sharding.axis_index(mesh, "stage")
    did = sharding.axis_index(mesh, "data")
    theta = theta if theta is not None else cfg.ff.theta

    def local_ff_update(x, unit, m, v, is_pos, step):
        """One unit's FF update: (its output y, detached; its loss)."""
        up = trainable(unit)
        with torch.enable_grad():
            h = x
            total = torch.zeros((), device=x.device)
            for kind, bp in zip(pattern, up):
                h_sg = h.detach()
                y, moe_aux = blocks.block_apply(bp, cfg, kind, h_sg, _CTX)
                g = ff.mean_goodness(y - h_sg)
                total = total + ff.ff_loss_masked(g, is_pos, theta) \
                    + AUX_WEIGHT * moe_aux
                h = y
            grads = grads_of(total, up)
        grads = [sharding.pmean(g.contiguous(), mesh, "data")
                 for g in grads]
        adam_leaves(unit, grads, m, v, lr=lr, step=step)
        return h.detach(), _reduce_scalar(total.detach(), mesh, "data",
                                          "mean")

    def step_fn(params, opt_state, batch, inflight, step):
        tokens = batch["tokens"][:, :-1]
        B = tokens.shape[0]
        dev = tokens.device
        neg = ff.corrupt_tokens(key_fn(seed).fold_in(step), tokens,
                                cfg.vocab)
        rows = 2 * B // n_data
        x_tok = torch.cat([tokens, neg], dim=0)[did * rows:(did + 1) * rows]
        is_pos = torch.cat([torch.ones((B,), device=dev),
                            torch.zeros((B,), device=dev)]
                           )[did * rows:(did + 1) * rows]
        with torch.no_grad():
            x_in = F.embedding(x_tok.long(), params["embed"])
        # stage 0 takes the fresh embeddings, the others their register
        x = x_in if sid == 0 else inflight[0]
        group = params["groups"][0]
        gm = opt_state["m"]["groups"][0]
        gv = opt_state["v"]["groups"][0]
        loss = torch.zeros((), device=dev)
        for r in range(repeat // stages):
            x, unit_loss = local_ff_update(
                x, unit_views(group, r), unit_views(gm, r),
                unit_views(gv, r), is_pos, step)
            loss = loss + unit_loss
        # the stage's output goes to stage (s + 1) mod P: the register
        new_inflight = sharding.shift(x, mesh, "stage")[None]
        loss = _reduce_scalar(loss, mesh, "stage", "sum")
        return params, opt_state, new_inflight, {"loss_ff": loss}

    return step_fn


def init_inflight(cfg, batch, seq, mesh=None, *, device=None):
    """This rank's zero pipeline register: its slot (1, 2*batch / data
    size, seq, d_model) of the reference's (stages, 2*batch, seq,
    d_model), in the config's dtype."""
    rows = 2 * batch // sharding.axis_size(mesh, "data")
    return torch.zeros((1, rows, seq, cfg.d_model),
                       dtype=common.dtype_of(cfg), device=device)

