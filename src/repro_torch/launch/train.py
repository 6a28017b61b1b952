"""Training launcher (the port of ``repro.launch.train``).

Three modes, on the card unless ``--device cpu``:

  * ``--paper-mlp``: the paper's own experiment, the FF MLP on the
    synthetic image task (``mnist_like``, or ``cifar_like`` with
    ``--cifar``) through ``api.fit`` on ``--backend``, then the
    simulator's sequential / single_layer / all_layers schedules over
    the fit's task times.
  * ``--arch <id>``: the joint FF step (``core.train.make_ff_train_step``;
    ``--baseline``: the backprop step) of a registered LM config,
    ``.reduced()`` unless ``--full``, on the synthetic LM corpus
    (``data.lm_batches``) for ``--steps`` steps. A config that reads stub
    frontend embeddings (an encoder-decoder's audio frames, a vision
    config's patches) gets them from ``launch.serve.frontend_embeddings``
    (batch ``--batch``, seed ``--seed``), drawn once and fed every step as
    the reference draws its ``jax.random.normal`` once; the stream
    differs from the reference's.
  * ``--arch <id> --chapters N``: the paper's chapter schedule over
    blocks on the real-text BPE source (``data.text_source``) through
    ``api.fit``, sequentially or on the executor's ``--nodes`` CUDA
    streams (``--backend executor --schedule ...``). The schedule takes
    no stub embeddings and refuses the encoder-decoder and vision configs
    (``core.pff_lm.check_chapter_config``).

``--ckpt`` saves the trained params in ``repro_torch.checkpoint``'s
format (the reference's: either package restores the other's files);
``--trace`` records the run (``repro_torch.obs``) and exports it in
``--trace-format``. ``--backend pod`` raises as ``api.fit`` does.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --paper-mlp \\
      --neg-mode random --classifier goodness --epochs 60 --splits 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-large-v2 --full --steps 2 --batch 4 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --chapters 4 --backend executor --schedule single_layer --nodes 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import api, checkpoint, data as data_lib, optim
from repro_torch.configs import get_config, list_configs
from repro_torch.configs.ff_mlp import FFMLPConfig
from repro_torch.core import pff_dag, train as train_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import registry as kernel_registry
from repro_torch.launch.serve import frontend_embeddings
from repro_torch.models import transformer
from repro_torch.obs import export as obs_export, trace as obs_trace


def run_paper_mlp(args):
    """``api.fit`` of the FF MLP; returns its ``FitResult``."""
    task = (data_lib.cifar_like if args.cifar else data_lib.mnist_like)(
        seed=args.seed, n_train=args.n_train, n_test=args.n_test)
    sizes = (task.dim,) + tuple(args.hidden for _ in range(args.layers))
    cfg = FFMLPConfig(
        layer_sizes=sizes, epochs=args.epochs, splits=args.splits,
        neg_mode=args.neg_mode or FFMLPConfig.neg_mode,
        classifier=args.classifier,
        goodness_fn=args.goodness_fn, batch_size=args.batch,
        kernel_impl=args.kernel_impl, seed=args.seed)
    backend = args.backend
    if backend == "sequential" and args.schedule == "federated":
        backend = "federated"          # pre-facade CLI spelling
    t0 = time.time()
    res = api.fit(cfg, task, backend=backend, schedule=args.schedule,
                  num_nodes=args.nodes, probe_every=args.probe,
                  verbose=True, trace=args.tracer, device=args.device)
    wall = time.time() - t0
    acc = f"test acc {res.test_acc:.4f}" if res.test_acc is not None else ""
    print(f"\n[{backend}] {acc}  wall {wall:.1f}s")
    if res.makespan is not None:
        speed = (f" speedup={res.speedup:5.2f}x "
                 f"util={res.utilization:.2f}"
                 if res.speedup is not None else "")
        print(f"  {res.schedule} N={res.num_nodes}: "
              f"makespan={res.makespan:8.2f}s{speed}")
    if res.records:
        for sched, n in (("sequential", 1), ("single_layer", args.nodes),
                         ("all_layers", args.nodes)):
            sim = api.simulate(res, sched, n)
            print(f"  {sched:13s} N={n}: time={sim.makespan:8.1f}s "
                  f"speedup={sim.speedup:5.2f}x "
                  f"util={sim.utilization:.2f}  (simulated)")
    return res


def run_lm_chapters(args, cfg):
    """The LM chapter schedule on real text (``--chapters N``) through
    ``api.fit``; returns its ``FitResult``."""
    tracer = args.tracer
    source = data_lib.text_source(vocab=cfg.vocab, seq_len=args.seq,
                                  seed=args.seed)
    t0 = time.time()
    res = api.fit(cfg, source, backend=args.backend,
                  schedule=args.schedule, num_nodes=args.nodes,
                  chapters=args.chapters,
                  steps_per_chapter=args.steps_per_chapter,
                  batch=args.batch, seq=args.seq, lr=args.lr,
                  head_lr=args.head_lr,
                  trace=tracer if tracer.enabled else None,
                  device=args.device)
    wall = time.time() - t0
    print(f"\n[{args.backend}] {res.schedule} N={res.num_nodes}: "
          f"chapters={args.chapters} eval_ce={res.eval_ce:.4f} "
          f"makespan={res.makespan:.2f}s wall={wall:.1f}s")
    if args.ckpt:
        checkpoint.save(args.ckpt, res.params,
                        step=args.chapters * args.steps_per_chapter,
                        tracer=tracer)
        print("saved", args.ckpt)
    return res


def run_lm(args):
    """``--arch``: the chapter schedule with ``--chapters``, else the
    joint FF (or backprop) step for ``--steps`` steps. The joint mode
    returns ``{"cfg", "params", "opt_state", "metrics"}`` (the last a list
    of each step's metrics as floats)."""
    tracer = args.tracer
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.neg_mode:
        cfg = dataclasses.replace(
            cfg, ff=dataclasses.replace(cfg.ff, neg_mode=args.neg_mode))
    if args.chapters:
        return run_lm_chapters(args, cfg)
    dev = resolve_device(args.device)
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(args.seed), cfg)
    opt = optim.adam_init(params)
    make = (train_lib.make_bp_train_step if args.baseline
            else train_lib.make_ff_train_step)
    step_fn = make(cfg, lr=args.lr)
    aux = frontend_embeddings(cfg, args.batch, args.seed, dev)

    history = []
    t0 = time.time()
    with tracer.span("train:lm", arch=args.arch, steps=args.steps):
        for i, tokens in enumerate(data_lib.lm_batches(
                cfg.vocab, args.batch, args.seq, args.steps, args.seed)):
            batch = {"tokens": torch.as_tensor(tokens, device=dev)}
            if aux is not None:
                batch["aux"] = aux
            params, opt, metrics = step_fn(params, opt, batch, i + 1)
            history.append({k: float(v) for k, v in metrics.items()})
            if (i + 1) % args.log_every == 0:
                m = {k: round(v, 4) for k, v in history[-1].items()}
                print(f"step {i + 1}: {m}  ({time.time() - t0:.1f}s)")
    if args.ckpt:
        checkpoint.save(args.ckpt, params, step=args.steps, tracer=tracer)
        print("saved", args.ckpt)
    return {"cfg": cfg, "params": params, "opt_state": opt,
            "metrics": history}


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the chosen mode;
    returns its result (see ``run_paper_mlp``, ``run_lm``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paper-mlp", action="store_true")
    ap.add_argument("--cifar", action="store_true")
    ap.add_argument("--arch", default=None, choices=list_configs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="backprop baseline instead of FF")
    # choices sourced from the live registries, so --help stays truthful
    # when strategies are (un)registered
    ap.add_argument("--backend", default="sequential",
                    choices=list(api.BACKENDS),
                    help="api.fit backend (--paper-mlp, --chapters): "
                         "sequential trainer, event simulator, the "
                         "executor on CUDA streams, federated shards, or "
                         "the pod pipeline (not ported yet: raises)")
    ap.add_argument("--schedule", default="all_layers",
                    choices=list(pff_dag.SCHEDULES))
    ap.add_argument("--neg-mode", default=None,
                    choices=[None] + list(api.negatives.names()))
    ap.add_argument("--classifier", default="goodness",
                    choices=list(api.classifier.names()))
    ap.add_argument("--goodness-fn", default="sumsq",
                    choices=list(api.goodness.names()))
    ap.add_argument("--kernel-impl", default="auto",
                    choices=list(kernel_registry.ff_dense.choices()),
                    help="ops.ff_dense impl (choices live from the kernel "
                         "registry): auto = the CUDA kernel on the card, "
                         "the plain version on the CPU")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=500)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--splits", type=int, default=10)
    ap.add_argument("--n-train", type=int, default=4032)
    ap.add_argument("--n-test", type=int, default=1000)
    ap.add_argument("--probe", type=int, default=0)
    ap.add_argument("--chapters", type=int, default=0,
                    help="--arch mode: run the LM CHAPTER schedule for "
                         "this many chapters on the real-text BPE "
                         "source (0 = the joint FF step on the "
                         "synthetic corpus); combine with --backend "
                         "sequential|executor and --schedule/--nodes")
    ap.add_argument("--steps-per-chapter", type=int, default=8,
                    help="per-task step budget of the chapter schedule")
    ap.add_argument("--head-lr", type=float, default=None,
                    help="chapter-head learning rate (default: --lr)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record an execution trace (repro_torch.obs) and "
                         "export it here after the run")
    ap.add_argument("--trace-format", default="chrome",
                    choices=list(obs_export.names()),
                    help="trace exporter (choices live from the obs "
                         "exporter registry); chrome loads in Perfetto / "
                         "chrome://tracing")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.tracer = (obs_trace.Tracer(meta={"launcher": "train"})
                   if args.trace else obs_trace.NOOP)
    if args.paper_mlp:
        out = run_paper_mlp(args)
    elif args.arch:
        out = run_lm(args)
    else:
        ap.error("need --paper-mlp or --arch")
    if args.tracer.enabled:
        obs_export.export(args.tracer, args.trace,
                          format=args.trace_format)
        print(f"trace: {args.tracer.span_count()} spans -> {args.trace} "
              f"({args.trace_format})")
    return out


if __name__ == "__main__":
    main()
