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

What differs from the reference: its per-device program comes from
GSPMD partitioning, which eager PyTorch has no counterpart for (the
port's steps take no mesh). So the port traces the whole step on one
device. Under ``--mesh pod1|pod2`` it adds the per-device argument bytes
(params, Adam state, inputs, caches) that the port's sharding rules give
rank 0, reports the compute and memory terms over ``chips`` as the ideal
split (``"per_device": "ideal_split"``), and its collective term is what
the traced program issued: 0 on one device. Nothing here sets
process-wide state (the reference's first lines write ``XLA_FLAGS``).

The terms use the H100 SXM's datasheet figures, as
``chip_smoke.py::bound`` does: bf16 989e12 FLOP/s, HBM 3.35e12 B/s, and
NVLink 450e9 B/s each way for the collective term.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k [--mesh pod1] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 8]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing
import os
import time

import torch

from repro_torch import sharding
from repro_torch.configs import INPUT_SHAPES, get_config, list_configs
from repro_torch.core import train as train_lib
from repro_torch.launch import op_analysis, specs as specs_lib
from repro_torch.models import transformer
from repro_torch.models.mlp import Dist

# H100 SXM (NVIDIA's datasheet, dense, per card)
PEAK_FLOPS = 989e12          # bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink, bytes/s each way


def _mesh(name):
    """None for ``"none"``, else the production mesh's sizes."""
    if name == "none":
        return None
    return specs_lib.SizesMesh(specs_lib.PRODUCTION_MESHES[name])


def make_dist(cfg, mesh, *, batch_fold_model=False):
    """The mesh axes' roles (the reference's ``make_dist``): the batch on
    ``sharding.batch_axes(mesh)``, the experts on "model", the expert
    weights' d_model on "data" for a MoE config. ``batch_fold_model``
    (the reference's §Perf option for dense configs whose heads do not
    split over the model axis) adds "model" to the batch axes. ``mesh``
    is a ``DeviceMesh``, or a mesh of sizes where nothing runs."""
    ba = sharding.batch_axes(mesh)
    if batch_fold_model:
        ba = ba + ("model",)
    return Dist(mesh=mesh, batch_axes=ba, model_axis="model",
                fsdp_axis="data" if cfg.moe is not None else None)


def _local_bytes(pairs, mesh):
    """Bytes of rank 0's shards of (stand-in, spec) pairs."""
    coords = {a: 0 for a in sharding.axis_names(mesh)}
    return sum(sharding.local_shard(t, s, mesh, coords).numel()
               * t.element_size() for t, s in pairs)


def trace_combo(cfg, shape, *, mesh=None, step_kind=None, lr=1e-3):
    """(outputs, op analysis, meta) of one combination's step traced on
    fake tensors. ``step_kind`` defaults from the shape's kind; a
    ``mesh`` (None or a mesh of sizes) adds the memory analysis's
    ``per_device_argument_bytes``."""
    kind = step_kind or shape.kind
    mode = specs_lib.new_mode()

    def split(out):
        return out if mesh is not None else (out, None)

    (params, opt), p_specs = split(specs_lib.param_specs_abstract(
        cfg, mesh, with_opt=(kind == "train"), mode=mode))
    if kind == "train":
        fn = train_lib.make_ff_train_step(cfg, lr=lr, impl="ref")
        inputs, i_specs = split(specs_lib.train_input_specs(
            cfg, shape, mesh, mode=mode))
        args = (params, opt, inputs, 1)
    elif kind == "prefill":
        def fn(params, batch):
            return transformer.prefill(params, cfg, batch["tokens"],
                                       aux=batch.get("aux"),
                                       last_only=True, impl="ref")
        inputs, i_specs = split(specs_lib.prefill_input_specs(
            cfg, shape, mesh, mode=mode))
        args = (params, inputs)
    elif kind == "decode":
        def fn(params, caches, tokens, pos):
            return transformer.serve_step(params, cfg, caches, tokens, pos)
        (caches, tokens, pos), d_specs = split(specs_lib.decode_input_specs(
            cfg, shape, mesh, mode=mode))
        inputs, i_specs = (caches, tokens), d_specs and d_specs[:2]
        args = (params, caches, tokens, pos)
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    with mode:
        out, an = op_analysis.trace(fn, *args)
    sizes = sharding.axis_sizes(mesh)
    meta = {"arch": cfg.name, "shape": shape.name, "kind": kind,
            "mesh": sizes, "chips": math.prod(sizes.values()),
            "params": transformer.param_count(params)}
    if mesh is not None:
        an["memory"]["per_device_argument_bytes"] = _local_bytes(
            specs_lib.leaves_with_specs(((params, opt), inputs),
                                        (p_specs, i_specs)), mesh)
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


def analyze_combo(arch, shape, *, mesh="none", step_kind=None):
    """The roofline result of one combination: ``shape`` a name of
    ``INPUT_SHAPES`` or an ``InputShape`` of the caller's (the reference's
    keys; ``op_*_total`` for its ``hlo_*_total``, ``trace_s`` for its
    lower and compile times)."""
    cfg = get_config(arch)
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if not specs_lib.combo_is_applicable(cfg, shape.name):
        raise ValueError(f"{arch} x {shape.name}: inapplicable "
                         "(full attention at 500k)")
    t0 = time.perf_counter()
    _, an, meta = trace_combo(cfg, shape, mesh=_mesh(mesh),
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
        model_flops=mflops,
        compute_term_s=an["flops"] / chips / PEAK_FLOPS,
        memory_term_s=an["bytes"] / chips / HBM_BW,
        collective_term_s=an["collective_bytes"] / LINK_BW,
        flops_utilization=(mflops / an["flops"] if an["flops"] else 0.0),
        per_device="ideal_split" if chips > 1 else "one_device",
    )
    terms = {"compute": res["compute_term_s"],
             "memory": res["memory_term_s"],
             "collective": res["collective_term_s"]}
    res["bottleneck"] = max(terms, key=terms.get)
    return res


def all_combos():
    """(arch, shape) of every applicable combination."""
    return [(arch, shape) for arch in list_configs()
            for shape in INPUT_SHAPES
            if specs_lib.combo_is_applicable(get_config(arch), shape)]


def _run(arch, shape, mesh):
    try:
        return analyze_combo(arch, shape, mesh=mesh), None
    except Exception as e:  # noqa: BLE001 (reported by main, run goes on)
        return None, repr(e)[:200]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none"] + sorted(specs_lib.PRODUCTION_MESHES))
    ap.add_argument("--out", default=None,
                    help="write one JSON file per combination here")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, one process each")
    args = ap.parse_args(argv)
    combos = all_combos() if args.all else [(args.arch, args.shape)]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as ex:
            futs = [ex.submit(_run, a, s, args.mesh) for a, s in combos]
            results = [f.result() for f in futs]
    else:
        results = [_run(a, s, args.mesh) for a, s in combos]
    failures = []
    for (arch, shape), (res, err) in zip(combos, results):
        tag = f"{arch}__{shape}__{args.mesh}"
        if res is None:
            failures.append(tag)
            print(f"FAIL {tag}: {err}")
            continue
        if args.out:
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
        print(f"OK   {tag}: bottleneck={res['bottleneck']} "
              f"compute={res['compute_term_s']:.4f}s "
              f"memory={res['memory_term_s']:.4f}s "
              f"collective={res['collective_term_s']:.4f}s "
              f"peak={res['memory']['peak_size_in_bytes'] / 2 ** 30:.1f}"
              f" GiB (trace {res['trace_s']}s)")
    if failures:
        raise SystemExit(f"{len(failures)} combos failed: "
                         + ", ".join(failures))
    print(f"all {len(combos)} combos traced")
    return results


if __name__ == "__main__":
    main()
