"""LM serving launcher: batched prefill, then greedy decode against the
caches (the port of ``repro.launch.serve``'s ``--mode lm``).

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \\
      --arch qwen2-0.5b --batch 4 --prompt-len 64 --gen 32

runs the reduced config on the card (``--full`` for the published
widths and depth, ``--device cpu`` for the plain path on the CPU). The
prefill goes through the hand-written attention and SSD kernels
(``kernels/csrc/flash_attention.cu``, ``kernels/csrc/mamba2_ssd.cu``);
decode is plain torch. The SSD kernel is compiled for both the reduced
mamba2 config (N 16, hd 32, chunk 32) and the full one. ``--mode ff``
(train-while-serve through ``api.serve``) waits for the train-while-serve
slice (``ROADMAP.md`` §1).
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
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("ff", "lm"), default="lm",
                    help="lm: transformer prefill + decode (ff: "
                         "train-while-serve, not ported yet)")
    ap.add_argument("--arch", default=None, choices=list_configs(),
                    help="transformer config name")
    ap.add_argument("--full", action="store_true",
                    help="published widths and depth (default: reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "ff":
        ap.error("--mode ff (train-while-serve) is not ported yet; it "
                 "waits for the train-while-serve slice (ROADMAP.md §1)")
    if args.arch is None:
        ap.error("--mode lm requires --arch")
    return _main_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
