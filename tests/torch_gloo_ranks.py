"""Four gloo ranks for the port's multi-process tests, started from a
fresh interpreter so that no rank loads JAX:

    PYTHONPATH=src:tests python -m torch_gloo_ranks {ring,pod} OUTDIR

spawns 4 processes (the ``spawn`` start method), joined in one gloo
group through a ``FileStore`` under OUTDIR. Each rank runs every case of
the suite, one thread each, and saves what it computed to
``OUTDIR/rank<r>.pt``; the test files hold the results against the
reference and the in-process oracle ``pod_oracle``, which
``chip_smoke.py`` holds the card's pod fit against too. This module
imports torch, numpy and ``repro_torch`` only.

ring  ``models.ring_attention.ring_attention`` on the inputs the test
      wrote to ``OUTDIR/ring_inputs.npz``, over a (seq=4) mesh, and the
      first case again over a (data=2, seq=2) mesh with the batch split.
pod   ``core.pff_pod``'s step over (stage, data, model) meshes of (4, 1,
      1) and (2, 2, 1) for ``POD_STEPS`` steps; ``api.fit(backend="pod",
      num_nodes=4)``; the expert-parallel MoE over (data=2, model=2),
      fsdp on data, in both branches, and its refusal under autograd.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4

# the pod cases: the reduced tinyllama-1.1b at 4 blocks, batch and seq
POD_BLOCKS, POD_BATCH, POD_SEQ, POD_STEPS, POD_LR = 4, 2, 16, 3, 1e-3
POD_LAYOUTS = ((4, 1), (2, 2))          # (stages, data)
FIT_STEPS = 2
# the MoE cases: (config, B, S) of the global batch; with data 2 each rank
# holds B/2 rows: T = 160 > 64 * top_k (sorted) and T = 32 (dense-local)
MOE_CASES = (("deepseek-moe-16b", 4, 80), ("deepseek-moe-16b", 4, 16),
             ("qwen3-moe-235b-a22b", 4, 80), ("qwen3-moe-235b-a22b", 4, 16))


def pod_config():
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b").reduced()
    return dataclasses.replace(cfg, num_layers=POD_BLOCKS,
                               groups=((("attn",), POD_BLOCKS),))


def moe_inputs(name, B, S):
    """(cfg, full MoE params, x (B, S, d)) of one MoE case, from seeds."""
    from repro_torch.configs import get_config
    from repro_torch.models import mlp
    cfg = get_config(name).reduced()
    p = mlp.moe_init(torch.Generator().manual_seed(1), cfg.moe,
                     cfg.d_model, torch.float32)
    x = np.random.default_rng(B * 1000 + S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, p, torch.tensor(x)


def pod_oracle(cfg, params, batches, *, stages=1, n_data=1, lr, seed=0,
               key_fn=None):
    """The pod pipeline with every (stage, data shard) in this one
    process, in order: stages 0..P-1, each over its data shards; each
    unit's grads computed per shard with the unit's pre-update params and
    averaged in rank order before its Adam step; the registers a list,
    stage s's output the next step's input of stage s + 1 (zeros at step
    1). Negatives from ``key_fn(seed).fold_in(step)`` (``TorchKey`` by
    default). Updates ``params`` (the whole model) in place; returns the
    per-step losses (0-d tensors)."""
    import torch.nn.functional as F
    from repro_torch import optim
    from repro_torch.core import ff
    from repro_torch.core.rng import TorchKey
    from repro_torch.core.train import (AUX_WEIGHT, REF, adam_leaves,
                                        grads_of, trainable, unit_views)
    from repro_torch.models import blocks, common

    key_fn = key_fn or TorchKey
    (pattern, repeat), = cfg.groups
    group = params["groups"][0]
    opt = optim.adam_init({"groups": params["groups"]})
    gm, gv = opt["m"]["groups"][0], opt["v"]["groups"][0]
    per = repeat // stages
    regs, losses = None, []
    for step, tok in enumerate(batches, 1):
        tok = torch.as_tensor(tok)[:, :-1]
        B, dev = tok.shape[0], tok.device
        rows = 2 * B // n_data
        if regs is None:
            regs = [[torch.zeros((rows, tok.shape[1], cfg.d_model),
                                 dtype=common.dtype_of(cfg), device=dev)
                     for _ in range(n_data)] for _ in range(stages)]
        neg = ff.corrupt_tokens(key_fn(seed).fold_in(step), tok, cfg.vocab)
        x_all = F.embedding(torch.cat([tok, neg]).long(), params["embed"])
        is_pos = torch.cat([torch.ones(B, device=dev),
                            torch.zeros(B, device=dev)])
        shard = [slice(d * rows, (d + 1) * rows) for d in range(n_data)]
        new_regs, stage_losses = [None] * stages, []
        for s in range(stages):
            xs = [x_all[sl] if s == 0 else regs[s][d]
                  for d, sl in enumerate(shard)]
            loss_s = torch.zeros((), device=dev)
            for r in range(s * per, (s + 1) * per):
                unit = unit_views(group, r)
                outs, gs, ls = [], [], []
                for d, sl in enumerate(shard):
                    up = trainable(unit)
                    with torch.enable_grad():
                        h, total = xs[d], torch.zeros((), device=dev)
                        for kind, bp in zip(pattern, up):
                            h_sg = h.detach()
                            y, aux = blocks.block_apply(bp, cfg, kind,
                                                        h_sg, REF)
                            g = ff.mean_goodness(y - h_sg)
                            total = total + ff.ff_loss_masked(
                                g, is_pos[sl], cfg.ff.theta) \
                                + AUX_WEIGHT * aux
                            h = y
                        gs.append(grads_of(total, up))
                    outs.append(h.detach())
                    ls.append(total.detach())
                grads = [sum(g[1:], g[0]) / n_data if n_data > 1 else g[0]
                         for g in zip(*gs)]
                adam_leaves(unit, grads, unit_views(gm, r),
                            unit_views(gv, r), lr=lr, step=step)
                xs = outs
                loss_s = loss_s + torch.stack(ls).mean()
            new_regs[(s + 1) % stages] = xs
            stage_losses.append(loss_s)
        regs = new_regs
        losses.append(torch.stack(stage_losses).sum())
    return losses


def run_ring(outdir):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.ring_attention import ring_attention
    data = np.load(os.path.join(outdir, "ring_inputs.npz"))
    n = len([k for k in data.files if k.startswith("q")])
    mesh = make_mesh((WORLD,), ("seq",))
    out = {}
    for i in range(n):
        q, k, v = (torch.tensor(data[f"{t}{i}"]) for t in "qkv")
        out[f"case{i}"] = ring_attention(q, k, v, mesh=mesh, axis="seq",
                                         causal=bool(data[f"causal{i}"]))
    mesh2 = make_mesh((2, 2), ("data", "seq"))
    q, k, v = (torch.tensor(data[f"{t}0"]) for t in "qkv")
    out["batch_split"] = ring_attention(q, k, v, mesh=mesh2, axis="seq",
                                        causal=bool(data["causal0"]),
                                        batch_axis="data")
    return out


def run_pod(outdir):
    from repro_torch import api, data as tdata, sharding
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.core import pff_pod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp, transformer
    cfg = pod_config()
    out = {}
    for stages, n_data in POD_LAYOUTS:
        mesh = make_mesh((stages, n_data, 1), ("stage", "data", "model"))
        params = transformer.init(torch.Generator().manual_seed(0), cfg)
        params["groups"] = (pff_pod.stage_rows(params["groups"][0], mesh),)
        opt = pff_pod.init_opt_state(params)
        inflight = pff_pod.init_inflight(cfg, POD_BATCH, POD_SEQ, mesh)
        step = pff_pod.make_pff_pod_step(cfg, mesh, lr=POD_LR, seed=0)
        losses = []
        for i, tok in enumerate(tdata.lm_batches(cfg.vocab, POD_BATCH,
                                                 POD_SEQ, POD_STEPS)):
            params, opt, inflight, m = step(
                params, opt, {"tokens": torch.as_tensor(tok)}, inflight,
                i + 1)
            losses.append(m["loss_ff"])
        out[f"pod{stages}x{n_data}"] = {
            "stage": sharding.axis_index(mesh, "stage"),
            "data": sharding.axis_index(mesh, "data"),
            "rows": params["groups"][0], "losses": losses,
            "inflight": inflight,
            # (bytes the storage holds, bytes of the rank's rows) per leaf
            "storage": [(t.untyped_storage().nbytes(),
                         t.numel() * t.element_size())
                        for t in tree_leaves(params["groups"][0])],
            "opt_keys": sorted(opt["m"])}
    fit = api.fit(cfg, backend="pod", num_nodes=WORLD, steps=FIT_STEPS,
                  batch=POD_BATCH, seq=POD_SEQ, lr=POD_LR, device="cpu")
    out["fit"] = {"params": fit.params, "history": fit.history,
                  "num_nodes": fit.num_nodes}
    mesh = make_mesh((2, 2), ("data", "model"))
    dist_ = mlp.Dist(mesh, ("data",), "model", "data")
    for name, B, S in MOE_CASES:
        cfg, p, x = moe_inputs(name, B, S)
        x = sharding.local_shard(x, ("data", None, None), mesh)
        y, aux = mlp.moe_apply(p, x, cfg.moe, cfg.act, dist_)
        out[f"moe:{name}:{B}x{S}"] = {
            "data": sharding.axis_index(mesh, "data"), "y": y, "aux": aux}
    # under autograd the expert-parallel MoE refuses (before any
    # collective, so every rank raises): its collectives carry no backward
    p = tree_map(lambda t: t.clone().requires_grad_(), p)
    try:
        mlp.moe_apply(p, x, cfg.moe, cfg.act, dist_)
        out["moe_grad_error"] = None
    except RuntimeError as e:
        out["moe_grad_error"] = str(e)
    return out


def _rank(rank, suite, outdir):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=WORLD)
    try:
        out = {"ring": run_ring, "pod": run_pod}[suite](outdir)
        out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0]
                               in ("jax", "jaxlib", "repro"))
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(_rank, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD,
                       start_method="spawn")
