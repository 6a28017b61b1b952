"""Four gloo ranks for the port's multi-process tests, started from a
fresh interpreter so that no rank loads JAX:

    PYTHONPATH=src:tests python -m torch_gloo_ranks {ring,pod,dist,dryrun} OUTDIR

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
      fsdp on data, in both branches.
dist  over a (data=2, model=2) mesh, on the inputs the test wrote to
      ``OUTDIR/dist_inputs.pkl`` and the draws to ``dist_draws.pkl``: the expert-parallel MoE's grads (each
      rank on its shards and its token block, fsdp on data, in both
      branches); one FF step at S 16 and one at S 80 and one backprop
      step of the reduced deepseek-moe-16b under ``make_dist`` and one
      AdaptiveNEG FF step at S 16 (its no-grad forward on the rank's
      rows, the logits gathered before the draw), each rank
      holding its blocks of the reference's rules
      (``transformer.shard_params``), the negatives replayed from the
      reference's recorded draws (``ReplayKey``), the tree gathered back;
      one FF step of the reduced qwen2-0.5b with the model axis folded
      into the batch; ``prefill`` and ``serve_step`` of the reduced
      deepseek on the rank's shard of the prompts; ``make_dist``'s fields
      for every config; then over (data 2, model 2), (data 1, model 4)
      and (data 4, model 1) meshes (``TP_LAYOUTS``) the tensor-parallel
      cases (``TP_CASES``): an FF step, a backprop step (``TP_BP``), the
      backprop loss's grads of the leaves the rank holds, and
      prefill then greedy decode on the rank's block of the prompts
      (the logits made whole from the ranks' vocab blocks, the tokens
      picked over them, the caches the rank holds), from the
      reference's own params (``tp_params``: written by
      ``jax_dist_ref``); the batch-1 cases (``B1_CASES``) the same way
      on caches whose slots, or SSM state's heads, split over "model";
      and every config's params through ``shard_params`` and back
      through ``gather_params``.
dryrun
      the steps ``launch.dryrun`` traces per rank (``DRY_KINDS`` of
      ``DRY_CFGS``, reduced) on real tensors over (data, model) meshes of
      ``DRY_LAYOUTS``, each rank holding what the dry run gives it, under
      ``launch.op_analysis``: the analysis of each.
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
    # the pod path's blocks: the plain route for attention too
    ctx = {**REF, "attn_impl": "ref"}
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
                                                        h_sg, ctx)
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
    from repro_torch.convert import tree_leaves
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
    return out


# the dist cases: the MoE grads' cotangent seed and the router aux weight
# of their loss; the steps' (batch, seq) and the served prompts
DIST_MOE_SEED, DIST_AUX = 7, 0.01
DIST_BATCH, DIST_PROMPT, DIST_GEN = 4, 80, 4
DIST_STEPS = {"ff16": 16, "ff80": 80, "bp": 80, "ada16": 16}
# the tensor-parallel cases, each on every layout of TP_LAYOUTS: (name,
# base config, fields replaced in its reduced()). On (data 2, model 2)
# and (data 1, model 4): qwen3-8b's 4 / 4 heads split, q and kv alike;
# qwen2-odd's 6 / 3 (hd 32) split its q heads but not its kv heads on
# model 2 (each rank's 3 queries read kv heads 0 0 1 or 1 2 2), and no
# head on model 4; recurrentgemma-2b's 4 / 1 split its q heads alone,
# beside its RG-LRU's gathered leaves; llama-3.2-vision-90b's cross
# attention (gates set to 1); mamba2-780m's gathered SSM leaves, its
# state split on hd in decode. The vocabularies split over "model"
# (vocab-parallel embed, head and CE): tied (qwen2, recurrentgemma with
# softcap 30, mamba2) and untied (qwen3, llama-vision); qwen3-8b's vocab
# of 500 pads to 512, its pad rows in the last block on model 2 and 4.
TP_CASES = (("qwen3-8b", "qwen3-8b", (("vocab", 500),)),
            ("qwen2-odd", "qwen2-0.5b",
             (("n_heads", 6), ("n_kv", 3), ("head_dim", 32))),
            ("recurrentgemma-2b", "recurrentgemma-2b", ()),
            ("llama-3.2-vision-90b", "llama-3.2-vision-90b", ()),
            ("mamba2-780m", "mamba2-780m", ()))
# (data 4, model 1): nothing split over "model"; the train batch's rows
# over 4 ranks, each rank's block of the stacked [pos; neg] rows made of
# two others' input blocks (llama-vision's stub rows moved point to
# point)
TP_LAYOUTS = ((2, 2), (1, 4), (4, 1))
TP_BATCH, TP_SEQ, TP_PROMPT, TP_GEN = 4, 16, 12, 4
# the cases whose backprop step runs too: the three head cases
TP_BP = ("qwen3-8b", "qwen2-odd", "recurrentgemma-2b")
# the batch-1 decode cases, on each layout of TP_LAYOUTS: (name, base
# config, fields, prompt, tokens generated). One prompt, which no data
# axis splits: the caches' slots split over "model" (cache_specs_tree's
# seq_axis_model), recurrentgemma's window of 32 and danube's of 64
# wrapped by their prompts (each ring's slots split), recurrentgemma's
# one kv head cut from every head computed, danube's 4 moved from the
# heads its ranks computed to their slots (an all-to-all); mamba2's SSM
# state split on its heads.
B1_CASES = (("recurrentgemma-2b", "recurrentgemma-2b", (), 40, 4),
            ("h2o-danube-3-4b", "h2o-danube-3-4b", (), 72, 4),
            ("mamba2-780m", "mamba2-780m", (), 12, 4))


def tp_params(outdir, name, timeout=600):
    """A tensor-parallel case's params as the reference's process wrote
    them (``jax_dist_ref``: its own init, numpy), waited for."""
    import pickle
    import time
    path = os.path.join(outdir, f"tp_params_{name}.pkl")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} not written in {timeout} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def tp_config(get_config, base, fields):
    """A tensor-parallel case's config: ``base``'s reduced one with
    ``fields`` replaced (``get_config`` of either package)."""
    return dataclasses.replace(get_config(base).reduced(), **dict(fields))


def moe_cotangent(x):
    """The fixed cotangent the MoE grad cases contract y with."""
    return torch.randn(x.shape, generator=torch.Generator().manual_seed(
        DIST_MOE_SEED))


def draw_key(path, method, shape):
    """The name of one recorded draw: the key's fold/split path, the
    draw and its shape."""
    return "/".join(map(str, path)) + f":{method}:" + "x".join(
        map(str, shape))


class ReplayKey:
    """``core.rng``'s key interface over recorded draws (``{draw_key:
    array}``): a fold or split extends the path, a draw reads the array
    recorded under it, so a rank that loads no jax consumes the
    reference's own numbers. ``categorical`` adds the recorded Gumbel
    noise to the logits it is given and takes the argmax, as
    ``jax.random.categorical`` does."""

    def __init__(self, draws, path):
        self.draws, self.path = draws, path

    @classmethod
    def factory(cls, draws):
        return lambda seed: cls(draws, (seed,))

    def fold_in(self, data):
        return ReplayKey(self.draws, self.path + ("f", int(data)))

    def split(self, n):
        return [ReplayKey(self.draws, self.path + ("s", n, i))
                for i in range(n)]

    def _draw(self, method, shape):
        return torch.as_tensor(self.draws[draw_key(self.path, method,
                                                   tuple(shape))])

    def permutation(self, n):
        return self._draw("permutation", (n,))

    def randint(self, shape, low, high):
        return self._draw(f"randint[{low},{high})", shape)

    def normal(self, shape):
        return self._draw("normal", shape)

    def bernoulli(self, shape, p):
        return self._draw("bernoulli", shape)

    def categorical(self, logits):
        g = self._draw("gumbel", logits.shape).to(logits.device)
        return torch.argmax(logits.float() + g, dim=-1)


def run_dist(outdir):
    import pickle

    from repro_torch import optim, sharding
    from repro_torch.configs import get_config, reference_names
    from repro_torch.convert import params_from_numpy, tree_leaves
    from repro_torch.core import train
    from repro_torch.launch.dryrun import make_dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import mlp, transformer

    with open(os.path.join(outdir, "dist_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    with open(os.path.join(outdir, "dist_draws.pkl"), "rb") as f:
        key_fn = ReplayKey.factory(pickle.load(f))
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {"coords": {a: sharding.axis_index(mesh, a)
                      for a in ("data", "model")},
           "make_dist": {}}
    for name in reference_names():
        for fold in (False, True):
            d = make_dist(get_config(name), mesh, batch_fold_model=fold)
            out["make_dist"][name, fold] = (tuple(d.batch_axes),
                                            d.model_axis, d.fsdp_axis)

    # (a) the MoE's grads on the rank's shards and token block
    ep = mlp.Dist(mesh, ("data",), "model", "data")
    for name, B, S in MOE_CASES:
        cfg, p, x = moe_inputs(name, B, S)
        held = transformer.shard_params({"mlp": p}, cfg, ep)["mlp"]
        leaves = [t.requires_grad_() for t in tree_leaves(held)]
        rows = sharding.block_of(x, mesh, ep.batch_axes)
        c = sharding.block_of(moe_cotangent(x), mesh, ep.batch_axes)
        y, aux = mlp.moe_apply(transformer.for_use({"mlp": held}, cfg,
                                                   ep)["mlp"],
                               rows, cfg.moe, cfg.act, ep)
        loss = (y * c).sum() / sharding.axes_size(mesh, ep.batch_axes) \
            + DIST_AUX * aux
        grads = train.RankPart(cfg, ep).grads(
            list(torch.autograd.grad(loss, leaves)), {"mlp": held})
        out[f"grad:{name}:{B}x{S}"] = grads

    # (b, c) the steps; each rank's tree gathered back whole
    def step(cfg, dist, make, npp, tokens, aux=None, **kw):
        params = params_from_numpy(npp, "cpu")
        held = transformer.shard_params(params, cfg, dist)
        opt = optim.adam_init(held)
        fn = make(cfg, dist=dist, lr=1e-3, **kw)
        # the rank's rows of the batch
        batch = {"tokens": sharding.block_of(torch.as_tensor(tokens),
                                             dist.mesh, dist.batch_axes)}
        if aux is not None:
            batch["aux"] = sharding.block_of(torch.as_tensor(aux), dist.mesh,
                                             dist.batch_axes)
        held, opt, metrics = fn(held, opt, batch, 1)
        return {"params": transformer.gather_params(held, cfg, dist),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "held": [(tuple(t.shape), t.untyped_storage().nbytes())
                         for t in tree_leaves(held)],
                "opt": [tuple(t.shape) for t in tree_leaves(opt["m"])]
                + [tuple(t.shape) for t in tree_leaves(opt["v"])]}

    moe = get_config("deepseek-moe-16b").reduced()
    ds = inputs["deepseek"]
    ep = make_dist(moe, mesh)
    for case in ("ff16", "ff80"):
        out[case] = step(moe, ep, train.make_ff_train_step, ds["params"],
                         ds[case], key_fn=key_fn)
    ada = dataclasses.replace(moe, ff=dataclasses.replace(
        moe.ff, neg_mode="adaptive"))
    out["ada16"] = step(ada, ep, train.make_ff_train_step, ds["params"],
                        ds["ada16"], key_fn=key_fn)
    out["bp"] = step(moe, ep, train.make_bp_train_step, ds["params"],
                     ds["bp"])
    dense = get_config("qwen2-0.5b").reduced()
    out["fold"] = step(dense, make_dist(dense, mesh, batch_fold_model=True),
                       train.make_ff_train_step, inputs["qwen2"]["params"],
                       inputs["qwen2"]["ff"], key_fn=key_fn)

    # (d) prefill and decode on the rank's shard of the prompts
    params = transformer.shard_params(params_from_numpy(ds["params"], "cpu"),
                                      moe, ep)
    prompts = sharding.block_of(torch.as_tensor(ds["prompts"]), mesh,
                                ep.batch_axes)
    logits, caches = transformer.prefill(
        params, moe, prompts[:, :DIST_PROMPT], dist=ep,
        max_len=DIST_PROMPT + DIST_GEN, impl="ref")
    served = [transformer.whole_logits(logits, moe, ep)]
    for i in range(DIST_GEN):
        logits, caches = transformer.serve_step(
            params, moe, caches, prompts[:, DIST_PROMPT + i],
            DIST_PROMPT + i, dist=ep)
        served.append(transformer.whole_logits(logits, moe, ep))
    out["serve"] = served

    # (e) the tensor-parallel cases, on each layout: the steps, and
    # prefill and greedy decode on the rank's block of the prompts
    def block(t, dist):
        """The rank's rows of ``t``, or ``t`` where the batch axes do
        not divide them (batch 1)."""
        if t is None:
            return None
        t = torch.as_tensor(t)
        if t.shape[0] % sharding.axes_size(dist.mesh, dist.batch_axes):
            return t
        return sharding.block_of(t, dist.mesh, dist.batch_axes)

    def serve(cfg, dist, npp, prompts, aux, gen=TP_GEN):
        params = transformer.shard_params(params_from_numpy(npp, "cpu"),
                                          cfg, dist)
        rows = block(prompts, dist)
        P = rows.shape[1]
        logits, caches = transformer.prefill(
            params, cfg, rows, aux=block(aux, dist), dist=dist,
            max_len=P + gen, impl="ref")
        heads = set()
        sharding.map_with_path(
            lambda path, t: heads.add(t.shape[3]) if path[-1] in ("k", "v")
            else None, caches)
        res = {"logits": [transformer.whole_logits(logits, cfg, dist)],
               "tokens": [], "kv_heads": sorted(heads),
               "vocab_block": logits.shape[-1]}
        for i in range(gen):
            tok = transformer.greedy(
                logits[:, -1] if logits.dim() == 3 else logits, cfg, dist)
            res["tokens"].append(tok)
            logits, caches = transformer.serve_step(
                params, cfg, caches, tok, P + i, dist=dist)
            res["logits"].append(transformer.whole_logits(logits, cfg,
                                                          dist))
        res["caches"] = caches
        return res

    def bp_grads(cfg, dist, npp, tokens, aux):
        # the backprop step's loss (its rows' mean CE, over the whole
        # batch's count) and its grads of the leaves the rank holds,
        # summed as the step sums them: the raw grads, which Adam's first
        # step would hide a uniform factor in
        held = transformer.shard_params(params_from_numpy(npp, "cpu"), cfg,
                                        dist)
        part = train.RankPart(cfg, dist)
        tokens = torch.as_tensor(tokens)
        rows = part.rows(tokens)
        aux = None if aux is None else part.rows(torch.as_tensor(aux))
        tp = train.trainable(held)
        logits, _ = transformer.forward(tp, cfg, rows[:, :-1], aux=aux,
                                        dist=dist, impl="ref")
        ce = train.vocab_ce(logits, rows[:, 1:], transformer.vocab_block(
            cfg, dist, logits.shape[-1]))
        loss = ce.mean() * (rows.shape[0] / tokens.shape[0])
        return part.grads(train.grads_of(loss, tp), held)

    for layout in TP_LAYOUTS:
        tmesh = make_mesh(layout, ("data", "model"))
        out[f"coords:{layout}"] = {a: sharding.axis_index(tmesh, a)
                                   for a in ("data", "model")}
        for name, base, fields in TP_CASES:
            case = inputs["tp"][name]
            params = tp_params(outdir, name)
            cfg = tp_config(get_config, base, fields)
            d = make_dist(cfg, tmesh)
            aux = case.get("aux")
            res = out[f"tp:{name}:{layout}"] = {
                "ff": step(cfg, d, train.make_ff_train_step, params,
                           case["tokens"], aux, key_fn=key_fn),
                "serve": serve(cfg, d, params, case["prompts"], aux)}
            if name in TP_BP:
                res["bp"] = step(cfg, d, train.make_bp_train_step, params,
                                 case["tokens"], aux)
            res["grads"] = bp_grads(cfg, d, params, case["tokens"], aux)
        for name, base, fields, _, gen in B1_CASES:
            cfg = tp_config(get_config, base, fields)
            out[f"b1:{name}:{layout}"] = serve(
                cfg, make_dist(cfg, tmesh), tp_params(outdir, f"b1-{name}"),
                inputs["b1"][name]["prompts"], None, gen)
        # (f) every config's tree through shard_params and gather_params
        for name in reference_names():
            cfg = get_config(name).reduced()
            d = make_dist(cfg, tmesh)
            params = transformer.init(torch.Generator().manual_seed(0), cfg)
            back = transformer.gather_params(
                transformer.shard_params(params, cfg, d), cfg, d)
            out[f"identity:{name}:{layout}"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                  tree_leaves(back)))
    return out


# the dryrun cases: configs, step kinds, (data, model) layouts, and the
# global batch: on (2, 2) a rank's prefill rows hold T = 160 tokens of the
# reduced deepseek-moe-16b (> 64 * top_k: the sorted branch and its
# all_to_all), on (4, 1) T = 80 (dense-local); decode at batch 1 on a
# DRY_SEQ-deep cache, its slots split over "model" (cache_specs_tree's
# seq_axis_model)
DRY_CFGS = ("qwen2-0.5b", "deepseek-moe-16b")
DRY_KINDS = ("train", "prefill", "decode")
DRY_LAYOUTS = ((4, 1), (2, 2))
DRY_BATCH, DRY_SEQ = 4, 80


def dry_shape(kind):
    """The ``InputShape`` of a dryrun case."""
    from repro_torch.configs import InputShape
    return InputShape(f"gloo_{kind}", DRY_SEQ,
                      1 if kind == "decode" else DRY_BATCH, kind)


def run_dryrun(outdir):
    from repro_torch import optim, sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer

    out = {}
    for layout in DRY_LAYOUTS:
        mesh = make_mesh(layout, ("data", "model"))
        for name in DRY_CFGS:
            cfg = get_config(name).reduced()
            d = dryrun.make_dist(cfg, mesh)
            for kind in DRY_KINDS:
                params = transformer.shard_params(transformer.init(
                    torch.Generator().manual_seed(0), cfg), cfg, d)
                tokens = torch.randint(
                    0, cfg.vocab, (DRY_BATCH, DRY_SEQ + (kind == "train")),
                    generator=torch.Generator().manual_seed(1),
                    dtype=torch.int32)
                # the rank's rows alone (a copy: a view would keep the
                # whole batch's storage among the arguments)
                rows = sharding.block_of(tokens, mesh, d.batch_axes).clone()
                if kind == "train":
                    args = (params, optim.adam_init(params),
                            {"tokens": rows}, 1)
                elif kind == "prefill":
                    args = (params, {"tokens": rows})
                else:
                    # its blocks of batch-1 caches (copies, as above)
                    caches = sharding.map_with_path(
                        lambda _, t: sharding.local_shard(
                            t, sharding.cache_leaf_spec(t.shape, mesh, True),
                            mesh).clone(),
                        transformer.init_caches(cfg, 1, DRY_SEQ,
                                                device="cpu"))
                    args = (params, caches, tokens[:1, 0].clone(),
                            DRY_SEQ - 1)
                _, an = op_analysis.trace(dryrun.step_fn(cfg, kind, d),
                                          *args)
                out[layout, name, kind] = an
    return out


def _rank(rank, suite, outdir):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=WORLD)
    try:
        out = {"ring": run_ring, "pod": run_pod, "dist": run_dist,
               "dryrun": run_dryrun}[suite](outdir)
        out["leaked"] = sorted(m for m in sys.modules if m.split(".")[0]
                               in ("jax", "jaxlib", "repro"))
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(_rank, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD,
                       start_method="spawn")
