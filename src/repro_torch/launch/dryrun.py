"""Dry run of every (arch x input-shape x mesh) combination on fake
tensors: trace the step, count what it does, and derive its roofline
terms on an H100 (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each combination against
ShapeDtypeStructs on a 512-device fake host mesh and reads the terms
from the compiled per-device program. The port has no compiler: it runs
the combination's step eagerly in a ``FakeTensorMode`` on
``launch.specs``'s stand-ins (nothing is allocated; each aten op runs
its shape logic) under ``launch.op_analysis``, on the plain route
(``impl="ref"``: a CUDA kernel cannot launch on a fake tensor):

  train    ``core.train.make_ff_train_step``'s step, with the Adam state;
  prefill  ``transformer.prefill(..., last_only=True)``;
  decode   ``transformer.serve_step`` on a ``seq_len``-deep cache.

Without a mesh the whole step runs on one device. With ``--mesh
pod1|pod2`` the dry run is per device, as the reference's is, but where
the reference's per-device program comes from GSPMD partitioning (which
eager PyTorch has no counterpart for), the port traces what one rank
(``--rank``) of its own ``Dist`` steps runs: a default process group on
torch's ``fake`` backend (no communication, no storage) at the mesh's
world size, a ``DeviceMesh`` over it, ``make_dist``, and the step with
``dist=`` on the arguments that rank holds (``_rank_args``: every one
the block of the reference's rules, its params and Adam state, its rows
of the batch, its blocks of the decode caches by ``cache_specs_tree``).
Every term is the rank's (``"per_device": "rank"``): its flops, its
bytes, the collectives it issues (c10d ops, counted by type and result
bytes) and its own memory. ``per_device_argument_bytes`` beside it is
what the reference's rules give rank 0 for every argument,
``rank_argument_bytes`` what the rank holds (equal; ``argument_bytes``
gives both without a trace), and ``rules_param_bytes`` /
``rank_param_bytes`` the params' and Adam state's part of each
(equal). ``--opts`` takes the reference's §Perf options:
``batch_fold_model`` folds "model" into the batch axes (a mesh and a
dense config only: every split leaf is then gathered where it is read);
``causal_skip`` and ``pv_bf16`` act on the chunked attention the plain
route runs (``models.attention.AttnOpts``, passed to the step as an
argument, where the reference sets module globals), with or without a
mesh. Nothing here sets process-wide state beyond the fake group,
destroyed after each trace (the reference's first lines write
``XLA_FLAGS``); it runs on the CPU with no GPU.

The terms use the H100 SXM's datasheet figures, as
``chip_smoke.py::bound`` does: bf16 989e12 FLOP/s, HBM 3.35e12 B/s, and
NVLink 450e9 B/s each way for the collective term.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--opts causal_skip,pv_bf16] [--mesh pod1
      [--rank R] [--opts batch_fold_model,causal_skip,pv_bf16]] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8]
      [--mesh pod1] [--opts causal_skip,pv_bf16]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import multiprocessing
import os
import time

import torch
import torch.distributed as tdist

from repro_torch import sharding
from repro_torch.configs import (INPUT_SHAPES, get_config, port_only,
                                  reference_names)
from repro_torch.convert import tree_leaves
from repro_torch.core import train as train_lib
from repro_torch.launch import op_analysis, specs as specs_lib
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.attention import AttnOpts
from repro_torch.models.mlp import NO_DIST, Dist

# H100 SXM (NVIDIA's datasheet, dense, per card)
PEAK_FLOPS = 989e12          # bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink, bytes/s each way


# a card's device memory, for the "fits" verdict: the H100's 80 GB
HBM_BYTES = 80e9

# the reference's §Perf options (``repro.launch.dryrun.lower_combo``)
OPTS = ("batch_fold_model", "causal_skip", "pv_bf16")


def mesh_sizes(mesh):
    """{axis: size} of a mesh given as None / ``"none"`` (``{}``), a name
    of ``specs.PRODUCTION_MESHES``, a dict of sizes, or a mesh object."""
    if mesh is None or mesh == "none":
        return {}
    if isinstance(mesh, str):
        return dict(specs_lib.PRODUCTION_MESHES[mesh])
    if isinstance(mesh, dict):
        return dict(mesh)
    return sharding.axis_sizes(mesh)


def check_opts(cfg, opts, sizes):
    """Raise ``ValueError`` for an option the port does not take with
    this config and mesh: an unknown one, or ``batch_fold_model`` without
    a mesh or on a MoE config (``causal_skip`` and ``pv_bf16`` go with
    any)."""
    for opt in opts:
        if opt not in OPTS:
            raise ValueError(f"unknown option {opt!r}; the reference's are "
                             f"{OPTS}")
    if "batch_fold_model" in opts:
        if not sizes:
            raise ValueError("batch_fold_model folds the mesh's model axis "
                             "into the batch axes: it needs a mesh")
        if cfg.moe is not None:
            raise ValueError(
                f"batch_fold_model is for dense configs; {cfg.name}'s MoE "
                "splits its experts over the model axis, so its tokens "
                "cannot be split over that axis too")


def refuse_port_only(cfg, what):
    """Raise ``ValueError`` for a config that has no counterpart in the
    reference (``configs.port_only``): the paths mirrored from the
    reference's (a ``Dist``, the dry run on any mesh, pod1 included)
    need what it lacks."""
    if port_only(cfg):
        raise ValueError(
            f"{cfg.name} cannot take {what}: MLA has no tensor-parallel "
            f"heads and no latent decode cache, and its sigmoid-routed MoE "
            f"no expert exchange (a card holds its share of the experts, "
            f"moe.experts_held), and the reference has no such config to "
            f"mirror; it trains on one card by chapters (core.pff_lm)")


def make_dist(cfg, mesh, *, batch_fold_model=False):
    """The mesh axes' roles (the reference's ``make_dist``): the batch on
    ``sharding.batch_axes(mesh)``, the experts on "model", the expert
    weights' d_model on "data" for a MoE config. ``batch_fold_model``
    (the reference's §Perf option for dense configs whose heads do not
    split over the model axis) adds "model" to the batch axes. ``mesh``
    is a ``DeviceMesh``, or a mesh of sizes where nothing runs. A
    port-only config (``configs.port_only``) is refused: its blocks take
    no ``Dist``."""
    refuse_port_only(cfg, "a Dist (a mesh's roles)")
    ba = sharding.batch_axes(mesh)
    if batch_fold_model:
        ba = ba + ("model",)
    return Dist(mesh=mesh, batch_axes=ba, model_axis="model",
                fsdp_axis="data" if cfg.moe is not None else None)


@contextlib.contextmanager
def fake_group(sizes, rank=0):
    """A ``DeviceMesh`` of ``sizes`` ({axis: size}) at ``rank``, over a
    default process group on torch's ``fake`` backend, which runs no
    communication and allocates nothing: each collective dispatches its
    c10d op and returns. The group is destroyed on exit, also when the
    body raises. Refuses to join a default group that already exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(sizes.values())
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside the mesh's {n} ranks")
    if tdist.is_initialized():
        raise RuntimeError("a default process group is already "
                           "initialized; the per-rank dry run makes its own")
    tdist.init_process_group(backend="fake", store=FakeStore(), rank=rank,
                             world_size=n)
    try:
        yield make_mesh(tuple(sizes.values()), tuple(sizes))
    finally:
        tdist.destroy_process_group()


def _local_bytes(pairs, mesh):
    """Bytes of rank 0's shards of (stand-in, spec) pairs."""
    coords = {a: 0 for a in sharding.axis_names(mesh)}
    return sum(sharding.local_shard(t, s, mesh, coords).numel()
               * t.element_size() for t, s in pairs)


def attn_opts(opts):
    """The chunked attention's options among ``opts``."""
    return AttnOpts(causal_skip="causal_skip" in opts,
                    pv_bf16="pv_bf16" in opts)


def step_fn(cfg, kind, dist=NO_DIST, lr=1e-3, opts=()):
    """The step the dry run traces for ``kind`` under ``dist``, on the
    plain route with ``opts``' attention options (``attn_opts``), as a
    function of the arguments ``_args`` gives (the train step's
    ``(params, opt, batch, step)``, prefill's ``(params, batch)``,
    decode's ``(params, caches, tokens, pos)``: decode attention takes
    no option, as the reference's ``decode_attention`` has none)."""
    if kind == "train":
        return train_lib.make_ff_train_step(cfg, dist=dist, lr=lr,
                                            impl="ref",
                                            attn_opts=attn_opts(opts))
    if kind == "prefill":
        def prefill(params, batch):
            return transformer.prefill(params, cfg, batch["tokens"],
                                       aux=batch.get("aux"), dist=dist,
                                       last_only=True, impl="ref",
                                       attn_opts=attn_opts(opts))
        return prefill

    def decode(params, caches, tokens, pos):
        return transformer.serve_step(params, cfg, caches, tokens, pos,
                                      dist=dist)
    return decode


def _args(cfg, shape, kind, mode, mesh=None):
    """(the step's arguments, whole, as stand-ins; with a ``mesh`` of
    sizes the (stand-in, spec) pairs of its params, Adam state and
    inputs under the reference's rules, else None)."""
    def split(out):
        return out if mesh is not None else (out, None)

    (params, opt), p_specs = split(specs_lib.param_specs_abstract(
        cfg, mesh, with_opt=(kind == "train"), mode=mode))
    if kind == "train":
        inputs, i_specs = split(specs_lib.train_input_specs(
            cfg, shape, mesh, mode=mode))
        args = (params, opt, inputs, 1)
    elif kind == "prefill":
        inputs, i_specs = split(specs_lib.prefill_input_specs(
            cfg, shape, mesh, mode=mode))
        args = (params, inputs)
    elif kind == "decode":
        (caches, tokens, pos), d_specs = split(specs_lib.decode_input_specs(
            cfg, shape, mesh, mode=mode))
        inputs, i_specs = (caches, tokens), d_specs and d_specs[:2]
        args = (params, caches, tokens, pos)
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    pairs = None if mesh is None else specs_lib.leaves_with_specs(
        ((params, opt), inputs), (p_specs, i_specs))
    return args, pairs


def _rank_args(cfg, kind, args, dist, mode):
    """``args`` (whole) as one rank of ``dist`` holds them in the port's
    ``Dist`` steps, each leaf the block of the reference's rules: params
    and Adam state by ``transformer.held_specs``; the train step's batch
    by rows (every leaf split over the batch axes, as the rules'
    ``data_spec``; the step raises on a batch they do not divide);
    prefill's batch and decode's tokens the rank's block where the axes
    divide them; the caches by ``sharding.cache_specs_tree`` with
    ``seq_axis_model`` at a batch of 1, as ``transformer.prefill``
    leaves them (``specs.cache_block``)."""
    params, opt = specs_lib.held_params(cfg, dist, with_opt=(kind == "train"),
                                        mode=mode, params=args[0])
    if kind == "train":
        return (params, opt, specs_lib.batch_block(
            args[2], dist, mode=mode, exact=True), args[3])
    if kind == "prefill":
        return params, specs_lib.batch_block(args[1], dist, mode=mode)
    caches, tokens, pos = args[1:]
    return (params, specs_lib.cache_block(
        caches, dist, mode=mode, seq_axis_model=tokens.shape[0] == 1),
        specs_lib.batch_block(tokens, dist, mode=mode), pos)


def _tensor_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def argument_bytes(cfg, shape, *, mesh, rank=0, opts=(), step_kind=None):
    """(``rank_argument_bytes``, ``per_device_argument_bytes``) of one
    combination on a mesh, with no trace: the bytes of the arguments
    rank ``rank`` holds (``_rank_args``, on stand-ins, inside a
    ``fake_group``) and of rank 0's blocks under the reference's rules.
    """
    kind = step_kind or shape.kind
    sizes = mesh_sizes(mesh)
    check_opts(cfg, tuple(opts), sizes)
    mode = specs_lib.new_mode()
    sizes_mesh = specs_lib.SizesMesh(sizes)
    args, pairs = _args(cfg, shape, kind, mode, sizes_mesh)
    with fake_group(sizes, rank) as dmesh:
        d = make_dist(cfg, dmesh, batch_fold_model="batch_fold_model" in opts)
        held = _tensor_bytes(_rank_args(cfg, kind, args, d, mode))
    return held, _local_bytes(pairs, sizes_mesh)


def trace_combo(cfg, shape, *, mesh=None, rank=0, opts=(), step_kind=None,
                lr=1e-3):
    """(outputs, op analysis, meta) of one combination's step traced on
    fake tensors. ``step_kind`` defaults from the shape's kind.

    Without a ``mesh`` the whole step runs on one device. With one (a
    name of ``specs.PRODUCTION_MESHES``, a dict of sizes, or a mesh
    object), the step is the one ``rank`` runs under ``make_dist`` on
    that mesh, traced over a fake process group (``fake_group``), on the
    arguments the rank holds (``_rank_args``); the memory analysis adds
    ``per_device_argument_bytes``, what the reference's rules would give
    rank 0, beside ``rank_argument_bytes``, what the rank holds (equal
    wherever the batch splits as the rules split it), and the params'
    part of each (``rank_param_bytes``, ``rules_param_bytes``). ``opts``:
    the
    reference's §Perf options (``check_opts``)."""
    kind = step_kind or shape.kind
    sizes = mesh_sizes(mesh)
    opts = tuple(opts)
    check_opts(cfg, opts, sizes)
    mode = specs_lib.new_mode()
    sizes_mesh = specs_lib.SizesMesh(sizes) if sizes else None
    args, pairs = _args(cfg, shape, kind, mode, sizes_mesh)
    meta = {"arch": cfg.name, "shape": shape.name, "kind": kind,
            "mesh": sizes, "chips": math.prod(sizes.values()),
            "params": transformer.param_count(args[0]), "opts": list(opts)}
    if not sizes:
        with mode:
            out, an = op_analysis.trace(
                step_fn(cfg, kind, NO_DIST, lr, opts), *args)
        return out, an, meta
    ref_bytes = _local_bytes(pairs, sizes_mesh)
    n_state = len(tree_leaves(args[:2] if kind == "train" else args[0]))
    meta.update(rank=rank)
    with fake_group(sizes, rank) as dmesh:
        d = make_dist(cfg, dmesh,
                      batch_fold_model="batch_fold_model" in opts)
        args = _rank_args(cfg, kind, args, d, mode)
        held = _tensor_bytes(args[:2] if kind == "train" else args[0])
        rank_bytes = _tensor_bytes(args)
        with mode:
            out, an = op_analysis.trace(step_fn(cfg, kind, d, lr, opts),
                                        *args)
    mem = an["memory"]
    mem["per_device_argument_bytes"] = ref_bytes
    mem["rank_argument_bytes"] = rank_bytes
    # the params' and Adam state's part of each (the rules', rank 0's)
    mem["rank_param_bytes"] = held
    mem["rules_param_bytes"] = _local_bytes(pairs[:n_state], sizes_mesh)
    return out, an, meta


def model_flops(cfg, shape, kind, total=None):
    """Reference FLOPs: 6*N_active*D (train) / 2*N_active*D (inference)
    plus the attention term 12*B*S^2*(H*hd) per attention layer (times 3
    for train fwd+bwd, halved for causality): the reference's formula,
    term for term. ``total``: the parameter count (default: counted from
    a fake ``transformer.init``)."""
    if total is None:
        total = param_total(cfg)
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        expert_p = 3 * cfg.d_model * m.expert_ff * m.num_experts \
            * cfg.num_layers
        active_expert = expert_p * m.top_k / m.num_experts
        active = total - expert_p + active_expert

    # attention layers and their effective context
    n_attn = 0
    ctx = shape.seq_len
    for pattern, repeat in cfg.groups:
        for kind_b in pattern:
            if kind_b in ("attn", "xdec"):
                n_attn += repeat
            elif kind_b == "local_attn":
                n_attn += repeat * min(
                    (cfg.rglru.window if cfg.rglru else cfg.window or ctx),
                    ctx) / ctx
    if cfg.window:
        ctx = min(cfg.window, ctx)
    hhd = cfg.n_heads * cfg.resolved_head_dim

    B, S = shape.global_batch, shape.seq_len
    if kind == "train":
        # pos+neg concat doubles tokens; FF ~ 3x fwd (fwd + 1-block bwd)
        tokens = 2 * B * S
        attn = 3 * 2 * 2 * tokens * (ctx / 2) * hhd * n_attn / 1
        return 6 * active * tokens + attn
    if kind == "prefill":
        tokens = B * S
        attn = 2 * 2 * tokens * (ctx / 2) * hhd * n_attn
        return 2 * active * tokens + attn
    # decode: 1 token/seq against a ctx-deep cache; enc-dec archs run
    # only the decoder blocks
    if cfg.enc_dec:
        embed_p = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings
                                             else 2)
        frac = cfg.num_layers / (cfg.num_layers + cfg.enc_layers)
        active = embed_p + (active - embed_p) * frac
    attn = 2 * 2 * B * ctx * hhd * n_attn
    return 2 * active * B + attn


def param_total(cfg):
    """``cfg``'s parameter count, from a fake ``transformer.init`` (no
    storage)."""
    with specs_lib.new_mode():
        return transformer.param_count(
            transformer.init(torch.Generator().manual_seed(0), cfg))


def analyze_combo(arch, shape, *, mesh="none", rank=0, opts=(),
                  step_kind=None):
    """The roofline result of one combination: ``shape`` a name of
    ``INPUT_SHAPES`` or an ``InputShape`` of the caller's (the reference's
    keys; ``op_*_total`` for its ``hlo_*_total``, ``trace_s`` for its
    lower and compile times). With a ``mesh`` every term is ``rank``'s
    (``"per_device": "rank"``): its flops over the peak, its bytes over
    HBM, its collective bytes over the link, its own memory; the
    utilization is the model's flops over the rank's times ``chips``, as
    the reference computes it."""
    cfg = get_config(arch)
    refuse_port_only(cfg, f"the dry run (mesh {mesh})")
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if not specs_lib.combo_is_applicable(cfg, shape.name):
        raise ValueError(f"{arch} x {shape.name}: inapplicable "
                         "(full attention at 500k)")
    t0 = time.perf_counter()
    _, an, meta = trace_combo(cfg, shape, mesh=mesh, rank=rank, opts=opts,
                              step_kind=step_kind)
    meta["trace_s"] = round(time.perf_counter() - t0, 1)
    chips = meta["chips"]
    mflops = model_flops(cfg, shape, meta["kind"], total=meta["params"])
    res = dict(meta)
    res.update(
        op_flops_total=an["flops"],
        op_bytes_total=an["bytes"],
        collective_bytes_per_dev=an["collective_bytes"],
        collective_by_type=an["collective_by_type"],
        collective_counts=an["collective_counts"],
        memory=an["memory"],
        fits_hbm=an["memory"]["peak_size_in_bytes"] <= HBM_BYTES,
        model_flops=mflops,
        compute_term_s=an["flops"] / PEAK_FLOPS,
        memory_term_s=an["bytes"] / HBM_BW,
        collective_term_s=an["collective_bytes"] / LINK_BW,
        flops_utilization=(mflops / (an["flops"] * chips)
                           if an["flops"] else 0.0),
        per_device="rank" if meta["mesh"] else "one_device",
    )
    terms = {"compute": res["compute_term_s"],
             "memory": res["memory_term_s"],
             "collective": res["collective_term_s"]}
    res["bottleneck"] = max(terms, key=terms.get)
    return res


def all_combos():
    """(arch, shape) of every applicable combination of the reference's
    configs."""
    return [(arch, shape) for arch in reference_names()
            for shape in INPUT_SHAPES
            if specs_lib.combo_is_applicable(get_config(arch), shape)]


def _run(arch, shape, mesh, rank, opts):
    try:
        return analyze_combo(arch, shape, mesh=mesh, rank=rank,
                             opts=opts), None
    except Exception as e:  # noqa: BLE001 (reported by main, run goes on)
        return None, repr(e)[:200]


def ok_line(tag, res):
    """The one-line summary ``main`` prints for a traced combination;
    with a mesh, whether the rank's peak fits the card, its arguments
    beside the reference rules' (all of them, and the params' and Adam
    state's part) and its collective bytes by type."""
    line = (f"OK   {tag}: bottleneck={res['bottleneck']} "
            f"compute={res['compute_term_s']:.4f}s "
            f"memory={res['memory_term_s']:.4f}s "
            f"collective={res['collective_term_s']:.4f}s "
            f"peak={res['memory']['peak_size_in_bytes'] / 2 ** 30:.1f} GiB")
    if res["mesh"]:
        moved = ", ".join(f"{k} {v}" for k, v in
                          res["collective_by_type"].items() if v) or "none"
        mem = res["memory"]
        line += (f" fits {HBM_BYTES / 1e9:.0f} GB: "
                 f"{'yes' if res['fits_hbm'] else 'no'}; arguments "
                 f"{mem['argument_size_in_bytes'] / 2 ** 30:.3f} GiB (the "
                 f"rank's rank_argument_bytes {mem['rank_argument_bytes']},"
                 f" the rules' per_device_argument_bytes "
                 f"{mem['per_device_argument_bytes']}: "
                 f"{mem['per_device_argument_bytes'] / 2 ** 30:.3f} GiB;"
                 f" params and Adam state "
                 f"{mem['rank_param_bytes'] / 2 ** 30:.3f}, the rules' "
                 f"{mem['rules_param_bytes'] / 2 ** 30:.3f}); collective "
                 f"bytes {moved}")
    return line + f" (trace {res['trace_s']}s)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none"] + sorted(specs_lib.PRODUCTION_MESHES))
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step a --mesh run traces")
    ap.add_argument("--opts", default="",
                    help="comma-separated §Perf options of the reference's: "
                         "batch_fold_model (with --mesh), causal_skip, "
                         "pv_bf16")
    ap.add_argument("--out", default=None,
                    help="write one JSON file per combination here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, one process each")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opts.split(",") if o)
    combos = all_combos() if args.all else [(args.arch, args.shape)]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    run = (args.mesh, args.rank, opts)
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as ex:
            futs = [ex.submit(_run, a, s, *run) for a, s in combos]
            results = [f.result() for f in futs]
    else:
        results = [_run(a, s, *run) for a, s in combos]
    suffix = "" if args.mesh == "none" else f"__rank{args.rank}"
    suffix += "".join(f"__{o}" for o in opts)
    failures = []
    for (arch, shape), (res, err) in zip(combos, results):
        tag = f"{arch}__{shape}__{args.mesh}{suffix}"
        if res is None:
            failures.append(tag)
            print(f"FAIL {tag}: {err}")
            continue
        if args.out:
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
        print(ok_line(tag, res))
    if failures:
        raise SystemExit(f"{len(failures)} combos failed: "
                         + ", ".join(failures))
    print(f"all {len(combos)} combos traced")
    return results


if __name__ == "__main__":
    main()
