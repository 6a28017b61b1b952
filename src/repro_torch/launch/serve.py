"""Serving launcher (the port of ``repro.launch.serve``).

``--mode ff`` (the default): train-while-serve through ``api.serve``.
The executor trains a goodness-classifier FF MLP on ``mnist_like`` on
``--nodes`` nodes (CUDA streams of the card) and hot-publishes every
freshly trained layer into the replica that serves ``--traffic`` at
``--rate`` requests/s meanwhile:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode ff \
      --schedule all_layers --nodes 4 --rate 300

``--mode lm``: batched prefill, then greedy decode against the caches:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch qwen2-0.5b --batch 4 --prompt-len 64 --gen 32

runs the reduced config on the card (``--full`` for the published
widths and depth). ``--arch`` is one of the eight registered configs:
``qwen2-0.5b``, ``tinyllama-1.1b``, ``qwen3-8b``, ``h2o-danube-3-4b``
(``attn`` blocks; head widths 64, 64, 128, 120; danube's sliding window
4096), ``mamba2-780m`` (``mamba2``), ``recurrentgemma-2b`` (``rglru``
and ``local_attn`` blocks, head width 256, local window 2048), and
``deepseek-moe-16b`` (MHA, 64 experts top-6 and 2 shared) and
``qwen3-moe-235b-a22b`` (GQA of 16, 128 experts top-8): ``attn`` blocks
with MoE MLPs. The prefill goes through the hand-written attention and
SSD kernels (``kernels/csrc/flash_attention.cu``,
``kernels/csrc/mamba2_ssd.cu``); the RG-LRU blocks, the MoE MLPs
(``models/mlp.py``: router, capacity dispatch in prefill, every expert
over the batch in decode) and decode are plain torch. The SSD kernel is
compiled for both the reduced mamba2 config (N 16, hd 32, chunk 32) and
the full one. ``--device cpu`` runs either mode's plain path on the
CPU. qwen3-moe-235b-a22b at its published depth (94 blocks, ~470 GB in
bf16) does not fit one card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import data as data_lib
from repro_torch.configs import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_decode(cfg, *, batch, prompt_len, gen, seed=0, greedy=True,
              params=None, device=None, impl="auto"):
    """Prefill a batch of prompts, then batched greedy decode against
    the caches.

    ``params=None`` draws random weights with ``transformer.init`` from
    a ``torch.Generator`` seeded by ``seed`` on the device; pass a tree
    (e.g. the reference's, through ``convert.params_from_numpy``) to
    serve given weights. Prompts are ``data.lm_batches(cfg.vocab, batch,
    prompt_len - 1, 1, seed)``. ``greedy=False`` samples each token from
    the softmax with a generator seeded by ``seed``. ``impl`` reaches
    the prefill's kernel ops. Times are host clocks behind
    ``torch.cuda.synchronize()``.
    """
    dev = resolve_device(device)
    if params is None:
        params = transformer.init(
            torch.Generator(device=dev).manual_seed(seed), cfg)
    prompts = torch.as_tensor(next(iter(data_lib.lm_batches(
        cfg.vocab, batch, prompt_len - 1, 1, seed))), device=dev)
    sampler = (None if greedy
               else torch.Generator(device=dev).manual_seed(seed))
    max_len = prompt_len + gen

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = transformer.prefill(params, cfg, prompts,
                                             max_len=max_len, last_only=True,
                                             impl=impl)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, dim=-1)             # (B,)
        out = [tok]
        t1 = time.perf_counter()
        for i in range(gen - 1):
            logits, caches = transformer.serve_step(params, cfg, caches, tok,
                                                    prompt_len + i)
            if greedy:
                tok = torch.argmax(logits, dim=-1)
            else:
                tok = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                        generator=sampler)[:, 0]
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t1
    return {
        "generated": torch.stack(out, dim=1),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }


def _main_ff(args):
    from repro_torch import api
    from repro_torch.configs.ff_mlp import FFMLPConfig
    from repro_torch.obs import export as obs_export, trace as obs_trace

    task = data_lib.mnist_like(n_train=args.n_train, n_test=400)
    cfg = FFMLPConfig(
        layer_sizes=(task.dim,) + (args.width,) * args.layers,
        epochs=args.epochs, splits=args.splits, neg_mode="random",
        classifier="goodness", batch_size=64, seed=args.seed)
    # block_tasks=False: the point of tracing a serve run is the live
    # interleaving of training and scoring, so keep the async overlap
    tracer = (obs_trace.Tracer(block_tasks=False,
                               meta={"launcher": "serve"})
              if args.trace else obs_trace.NOOP)
    res = api.serve(cfg, task, traffic=args.traffic,
                    schedule=args.schedule, num_nodes=args.nodes,
                    rate=args.rate, max_batch=args.max_batch,
                    max_wait_s=args.max_wait, queue_cap=args.queue_cap,
                    seed=args.seed, trace=tracer, device=args.device)
    if tracer.enabled:
        obs_export.export(tracer, args.trace, format=args.trace_format)
        print(f"trace: {tracer.span_count()} spans -> {args.trace} "
              f"({args.trace_format})")
    slo = res.slo
    print(f"train-while-serve: schedule={res.schedule} "
          f"nodes={res.num_nodes} traffic={res.traffic} "
          f"device={res.device}")
    print(f"  train acc={res.fit.test_acc:.4f} "
          f"makespan={res.fit.makespan:.2f}s")
    print(f"  served {slo['requests']} req @ "
          f"{slo['throughput_rps']:.1f} rps  "
          f"p50={slo['latency_p50_ms']:.1f}ms "
          f"p99={slo['latency_p99_ms']:.1f}ms  "
          f"shed={slo['shed_rate']:.3f}")
    print(f"  swaps={slo['swaps']} "
          f"staleness_max={slo['staleness_max_s']:.3f}s "
          f"violations={slo['consistency_violations']}")
    for v, row in res.accuracy_by_version.items():
        print(f"    version {v:3d}: n={row['n']:5d} "
              f"acc={row['accuracy']:.3f}")
    return 1 if slo["consistency_violations"] else 0


def _main_lm(args):
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    res = lm_decode(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, seed=args.seed, device=args.device)
    print(f"prefill {res['prefill_s']:.2f}s  decode {res['decode_s']:.2f}s"
          f"  ({res['decode_tok_per_s']:.1f} tok/s)")
    print("first generated rows:", res["generated"][:2, :12].cpu().numpy())
    return 0


def main(argv=None):
    from repro_torch.core import pff_dag
    from repro_torch.obs import export as obs_export
    from repro_torch.serve.traffic import traffic

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("ff", "lm"), default="ff",
                    help="ff: train-while-serve via api.serve (default); "
                         "lm: transformer prefill + decode")
    g = ap.add_argument_group("ff mode")
    g.add_argument("--traffic", default="uniform",
                   choices=list(traffic.names()))
    g.add_argument("--schedule", default="all_layers",
                   choices=list(pff_dag.SCHEDULES))
    g.add_argument("--nodes", type=int, default=4)
    g.add_argument("--rate", type=float, default=300.0)
    g.add_argument("--max-batch", type=int, default=64)
    g.add_argument("--max-wait", type=float, default=0.02)
    g.add_argument("--queue-cap", type=int, default=512)
    g.add_argument("--epochs", type=int, default=100)
    g.add_argument("--splits", type=int, default=4)
    g.add_argument("--layers", type=int, default=2)
    g.add_argument("--width", type=int, default=256)
    g.add_argument("--n-train", type=int, default=2560)
    g.add_argument("--trace", default=None, metavar="PATH",
                   help="record an execution trace (repro_torch.obs; "
                        "non-blocking tracer, overlap intact) and export "
                        "it here after the run")
    g.add_argument("--trace-format", default="chrome",
                   choices=list(obs_export.names()),
                   help="trace exporter (the obs exporter registry)")
    lm = ap.add_argument_group("lm mode")
    lm.add_argument("--arch", default=None, choices=list_configs(),
                    help="LM config name (the eight the port registers)")
    lm.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=64)
    lm.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        if args.arch is None:
            ap.error("--mode lm requires --arch")
        return _main_lm(args)
    return _main_ff(args)


if __name__ == "__main__":
    raise SystemExit(main())
