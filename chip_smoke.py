#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) starts and is
right on an NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``.
Phases, in order; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: ``nvcc`` builds the kernel library from ``kernels/csrc``.
3. Kernel against its plain version, on the card: ``ff_dense`` at the
   serving shapes and two ragged ones, norm off/on, f32 and bf16, plus a
   row forced all-dead. Errors are scaled by max |plain|.
4. Timing (CUDA events, L2 flushed before each call, median of 25; a
   spin kernel ahead of each call keeps host enqueue time out) of the
   kernel, its plain version and ``torch.addmm`` at the serving shapes,
   beside the least time the card could take (``bound_ms``).
5. Whole path: the paper's MLP (``PAPER_MLP``, full width and depth,
   random weights from a seed) scores one 64-row batch under three
   classifiers through the kernel and through the plain path.
6. Serving: ``repro_torch.api.serve`` answers 1024 requests; the kernel
   launch count must be 4 per scored batch.
7. Backward kernel against its plain version: ``ff_dense_bwd`` at the
   four training shapes and two ragged ones (dx, dw, db scaled by
   max |plain|), plus an all-dead row whose dg is NaN; a second call at
   (128, 2000, 2000) must give bit-identical outputs.
8. Gradients through ``FFDense``/``FFDenseNorm`` against autograd of the
   plain version, under the reference test's two losses.
9. Timing of the backward kernel, each of its three launches (grad_x,
   the slice sum, grad_w) at (128, 2000, 2000), and the forward at the
   training M, beside the plain version, the library yardstick and the
   bound; and one grad step's wall time against its device time.
10. Trainer parity: one chapter of ``train_layer_chapter`` (K = 784) and
    of ``train_layer_chapter_perf_opt`` (K = 2000, started off the relu
    boundary) through the kernels and through the plain path, from one
    key: weights within 1e-4.
11. Training, the main path: ``api.fit`` of ``PAPER_MLP`` (2 epochs,
    2 splits, 4096 samples) with the paper's defaults and with the §4.4
    goodness; the backward launch count must equal the grad steps, and
    a fit through the plain path must reach a test accuracy within 0.05.
12. Attention kernel against its plain version: ``flash_attention`` at
    the qwen2-0.5b prefill shape (bf16, f32), a ragged S with a window,
    G = 1 at hd 128, Sq != Sk non-causal, and rows that see no key; a
    second call must give bit-identical outputs.
13. SSD kernel against its plain version: ``mamba2_ssd`` at the
    mamba2-780m prefill shape (strong and mild decay), a ragged S and
    chunk 128.
14. Timing of both (CUDA events, L2 flushed) beside the plain versions,
    the bound and, for attention, ``F.scaled_dot_product_attention``.
15. LM serving, the main path: ``launch.serve.lm_decode`` of qwen2-0.5b
    and mamba2-780m at full width and depth (random weights from seed 0,
    batch 4, prompt 2048, 32 tokens) in bf16 through the kernels and
    through the plain path; 24 attention / 48 SSD kernel calls per
    prefill, none in decode; last-position prefill logits gated against
    the plain path; then once in f32, first tokens equal where decided.
16. Isolation: no ``jax`` and no ``repro`` module was loaded.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM published peaks: f32 outside the tensor cores, bf16 dense on
# the tensor cores, and HBM bandwidth.
F32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# (y, g) limits on max|kernel - plain| / max|plain|: the reference's own
# ff_dense tolerances (tests/test_kernels.py), g at 5x y's.
TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (3e-2, 1.5e-1)}
SERVING_SHAPES = [(640, 784, 2000), (640, 2000, 2000)]
CHECK_SHAPES = SERVING_SHAPES + [(100, 333, 257), (16, 64, 64)]
PATH_TOL = 1e-4                # whole-path scores, scaled
TIMING_REPS = 25
SPIN_CYCLES = 1_000_000        # ~0.5 ms: longer than any call's enqueue
STEP_SPIN_CYCLES = 20_000_000  # ~10 ms: longer than a grad step's enqueue
SERVE_REQUESTS = 1024

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/ff_dense.cu"
KERNEL_REPLACES = "src/repro/kernels/ff_dense.py:117"
BWD_SOURCE = "src/repro_torch/kernels/csrc/ff_dense_bwd.cu"
BWD_REPLACES = "src/repro/kernels/ff_dense_vjp.py:77"

# Training: pos and neg stacked (sumsq, M = 2B) and the §4.4 path
# (perf_opt, M = B) at the paper's batch of 64.
TRAIN_SHAPES = [(128, 784, 2000), (128, 2000, 2000), (64, 784, 2000),
                (64, 2000, 2000)]
BWD_CHECK_SHAPES = TRAIN_SHAPES + [(100, 333, 257), (16, 64, 64)]
# max|kernel - plain| / max|plain| for fused grads and the trainer
# weights: the reference's _scale_err gate (kernels/autotune.py:283) and
# its ref-vs-fused weight-stream gate (tests/test_ff_dense_vjp.py:216).
GRAD_TOL = 1e-4
WEIGHT_TOL = 1e-4
ACC_BAND = 0.05                # kernel fit vs plain fit, test accuracy
FIT_TRAIN, FIT_TEST = 4096, 1000

FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:72"
SSD_SOURCE = "src/repro_torch/kernels/csrc/mamba2_ssd.cu"
SSD_REPLACES = "src/repro/kernels/mamba2_ssd.py:67"
# max|kernel - plain| / max|plain|: the reference's own tolerances
# (tests/test_kernels.py): attention 2e-5 in f32, 5e-2 in bf16; SSD 2e-4.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
# bf16 attention, elementwise as well: both sides compute in f32 from the
# same bf16 inputs and round once to bf16, so they may differ by one bf16
# step (at most 2^-7 |plain|) plus f32 rounding (1e-4 max|plain|).
FA_BF16_REL, FA_BF16_ABS = 2.0 ** -7, 1e-4
SSD_TOL = 2e-4
# (B, Sq, Sk, H, KV, hd, causal, window): the qwen2-0.5b prefill first
QWEN_ATTN = (4, 2048, 2048, 14, 2, 64, True, None)
FA_CHECKS = [QWEN_ATTN, (2, 333, 333, 14, 2, 64, True, 128),
             (2, 512, 512, 4, 4, 128, True, None),
             (2, 300, 700, 8, 2, 64, False, None),
             (1, 90, 40, 2, 1, 128, False, 16)]
# (B, S, H, hd, N, chunk, decay): the mamba2-780m prefill first
MAMBA_SSD = (4, 2048, 48, 64, 128, 256)
SSD_CHECKS = [MAMBA_SSD + ("strong",), MAMBA_SSD + ("mild",),
              (2, 1000, 48, 64, 128, 256, "mild"),
              (2, 1024, 48, 64, 128, 128, "mild")]
# LM serving: batch, prompt and generated tokens; kernel calls per prefill
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_CALLS = {"qwen2-0.5b": ("flash_attention", 24),
            "mamba2-780m": ("mamba2_ssd", 48)}
# last-position prefill logits, kernel path vs plain path, scaled: bf16
# through 24 / 48 layers (the kernels' own bf16 limit), f32 at the
# tests' whole-path limit (PATH_TOL); f32 first tokens are held equal
# where the plain path's top-2 margin exceeds F32_MARGIN
LM_BF16_TOL = 5e-2
F32_MARGIN = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def scaled_err(a, ref):
    a, ref = a.float(), ref.float()
    return float((a - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def make_inputs(gen, M, K, N, dtype, *, dead_row=False):
    x = torch.randn(M, K, generator=gen)
    w = torch.randn(K, N, generator=gen) * K ** -0.5
    b = torch.randn(N, generator=gen) * 0.1
    if dead_row:
        # row 0 is x = 0 against an all-negative bias: relu kills it
        x[0] = 0.0
        b = -(b.abs() + 0.1)
    return [t.to(dtype).cuda() for t in (x, w, b)]


def time_ms(fn, flush, spin=None):
    """Median device time of one call, L2 flushed before each. A spin
    kernel (``spin`` cycles) ahead of the flush keeps the card busy while
    the host enqueues the call, so the span between the events holds no
    host time when the enqueue is shorter than the spin."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        torch.cuda._sleep(spin or SPIN_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(M, K, N, norm):
    """(ms, what bounds it): the larger of the operations over the f32
    peak and the bytes (each input read once, each output written once)
    over the memory rate."""
    flops = 2 * M * K * N + 4 * M * N + (M * N if norm else 0)
    nbytes = 4 * (M * K + K * N + N) + 4 * (M * N + M)
    return roofline(flops, nbytes)


def bwd_bound(M, K, N):
    """(ms, what bounds it) for ff_dense_bwd: 4*M*K*N operations (the two
    products) against x, w, y, dy_out, dg read once and dx, dw, db
    written once."""
    flops = 4 * M * K * N
    nbytes = 4 * (M * K + K * N + 2 * M * N + M) + 4 * (M * K + K * N + N)
    return roofline(flops, nbytes)


def bwd_inputs(gen, M, K, N, *, dead_row=False):
    """x, w, y (from the forward kernel), random dy_out and dg."""
    from repro_torch.kernels import ff_dense as kernel
    x, w, b = make_inputs(gen, M, K, N, torch.float32, dead_row=dead_row)
    y, _ = kernel.ff_dense(x, w, b)
    dy_out = torch.randn(M, N, generator=gen).cuda()
    dg = torch.randn(M, generator=gen).cuda()
    if dead_row:
        dg[0] = float("nan")    # what the norm fold gives an all-dead row
    return x, w, y, dy_out, dg


def stacked_ff_loss(ops_fn, peer_w):
    """tests/test_ff_dense_vjp.py::_stacked_ff_loss: the FF loss over a
    stacked [pos; neg] batch plus the peer term (dy and dg cotangents)."""
    from repro_torch.core import ff

    def loss(x, w, b):
        y, g = ops_fn(x, w, b)
        g = g / y.shape[-1]
        half = x.shape[0] // 2
        return (ff.ff_loss(g[:half], g[half:], 2.0)
                + peer_w * ff.peer_norm_loss(y[:half]))
    return loss


def normed_loss(ops_fn, v):
    """tests/test_ff_dense_vjp.py::_normed_loss: both outputs of the
    normed layer (dyn through a head product, dg through tanh)."""
    def loss(x, w, b):
        yn, g = ops_fn(x, w, b)
        return torch.mean((yn @ v) ** 2) + torch.mean(torch.tanh(g))
    return loss


def grads(loss, x, w, b):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    return torch.autograd.grad(loss(*leaves), leaves)


def top2_margin(scores):
    top = torch.topk(scores.float(), 2, dim=1).values
    return top[:, 0] - top[:, 1]


def fa_inputs(gen, B, Sq, Sk, H, KV, hd, dtype):
    q = torch.randn(B, Sq, H, hd, generator=gen)
    k = torch.randn(B, Sk, KV, hd, generator=gen)
    v = torch.randn(B, Sk, KV, hd, generator=gen)
    return [t.to(dtype).cuda() for t in (q, k, v)]


def fa_bound(B, Sq, Sk, H, KV, hd, causal, dtype):
    """(f32 operations, bytes, bf16 operations) for attention: the
    products over the visible pairs (half the dense pairs when causal),
    against q, k, v read once and out written once. In f32 both products
    count at the f32 FMA rate. In bf16 every product counts at the bf16
    tensor-core rate: Q.K^T on the bf16 inputs at every hd (the scale
    comes after the product), and P.V as two bf16 products, P split into
    bf16(p) and bf16(p - bf16(p)) to keep the reference's f32 P; counting
    P.V at the f32 rate would bound the function by a path the kernel
    does not take."""
    pairs = B * H * Sq * Sk / (2 if causal else 1)
    nbytes = (torch.finfo(dtype).bits // 8) * hd * (2 * B * Sq * H
                                                    + 2 * B * Sk * KV)
    qk = 2 * pairs * hd
    if dtype == torch.bfloat16:
        return 0, nbytes, 3 * qk
    return 2 * qk, nbytes, 0


def ssd_inputs(gen, B, S, H, hd, N, decay):
    """xbar, dA, b, c as the model forms them: dA = dt * A < 0, strong
    (-softplus(normal), the reference tests' draw) or mild (dt in
    [0.001, 0.1] against A = -1, mamba2's dt init, so the state carries
    across chunks)."""
    xbar = torch.randn(B, S, H, hd, generator=gen)
    if decay == "strong":
        dA = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen))
    else:
        dA = -torch.exp(torch.rand(B, S, H, generator=gen)
                        * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
    b = torch.randn(B, S, N, generator=gen)
    c = torch.randn(B, S, N, generator=gen)
    return [t.cuda() for t in (xbar, dA, b, c)]


def ssd_bound(B, S, H, hd, N, chunk):
    """(operations, bytes) for the SSD scan: scores 2·B·nc·N·L(L+1)/2,
    intra-chunk 2·B·H·nc·hd·L(L+1)/2, inter-chunk and state 2·2·B·S·H·hd·N
    operations at the f32 peak, against xbar, dA, b, c read once and y,
    hT written once."""
    L = min(chunk, S)
    nc = -(-S // L)
    tri = L * (L + 1) / 2
    flops = (2 * B * nc * N * tri + 2 * B * H * nc * hd * tri
             + 4 * B * S * H * hd * N)
    nbytes = 4 * (2 * B * S * H * hd + B * S * H + 2 * B * S * N
                  + B * H * hd * N)
    return flops, nbytes


def roofline(flops, nbytes, bf16_flops=0):
    """(ms, what bounds it): the larger of the operations (f32 ones over
    the f32 peak plus bf16 ones over the bf16 tensor-core peak) and the
    bytes over the memory rate."""
    t_ops = flops / F32_PEAK_FLOPS + bf16_flops / BF16_PEAK_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import api, data, optim
    from repro_torch.configs.ff_mlp import PAPER_MLP
    from repro_torch.core import ff_mlp
    from repro_torch.core.rng import TorchKey
    from repro_torch.kernels import _build, ff_dense as kernel
    from repro_torch.kernels import ff_dense_vjp as vjp

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind!r} count {torch.cuda.device_count()}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[2 build] kernel library ready in "
          f"{time.perf_counter() - t0:.2f} s: {_build.library_path().name}")
    print(_build.build_log().strip())

    # 3. kernel against its plain version ----------------------------------
    gen = torch.Generator().manual_seed(0)
    errs = {}
    for M, K, N in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = make_inputs(gen, M, K, N, dtype)
            for norm in (False, True):
                y, g = kernel.ff_dense(x, w, b, norm=norm)
                torch.cuda.synchronize()
                yp, gp = kernel.ff_dense_plain(x, w, b, norm=norm)
                torch.cuda.synchronize()
                check(y.dtype == dtype and g.dtype == torch.float32
                      and y.shape == (M, N) and g.shape == (M,),
                      f"ff_dense output types/shapes at {(M, K, N)}")
                check(bool(torch.isfinite(y.float()).all()
                           and torch.isfinite(g).all()),
                      f"non-finite ff_dense output at {(M, K, N)}")
                ey, eg = scaled_err(y, yp), scaled_err(g, gp)
                tol_y, tol_g = TOL[dtype]
                print(f"[3 check] ff_dense {(M, K, N)} {str(dtype)[6:]} "
                      f"norm={norm}: y err {ey:.3e} (<= {tol_y}), "
                      f"g err {eg:.3e} (<= {tol_g})")
                check(ey <= tol_y and eg <= tol_g,
                      f"ff_dense disagrees with its plain version at "
                      f"{(M, K, N)} {dtype} norm={norm}")
                if dtype == torch.float32:
                    errs[(M, K, N, norm)] = (
                        max(ey, eg),
                        float(max((y - yp).abs().max(),
                                  (g - gp).abs().max())))
    for dtype in (torch.float32, torch.bfloat16):
        x, w, b = make_inputs(gen, 64, 784, 2000, dtype, dead_row=True)
        for norm in (False, True):
            y, g = kernel.ff_dense(x, w, b, norm=norm)
            torch.cuda.synchronize()
            check(float(g[0]) == 0.0 and bool((y[0] == 0).all()),
                  f"dead row is not zero ({dtype}, norm={norm})")
            check(bool(torch.isfinite(y.float()).all()),
                  f"dead row produced NaN/inf ({dtype}, norm={norm})")
            check(bool((g[1:] > 0).any()), "dead-row case killed every row")
    print("[3 check] dead row: g == 0 and y == 0, no NaN (f32, bf16, "
          "norm off/on)")

    # 4. timing ------------------------------------------------------------
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for M, K, N in SERVING_SHAPES:
        x, w, b = make_inputs(gen, M, K, N, torch.float32)
        library_ms = time_ms(lambda: torch.addmm(b, x, w), flush)
        for norm in (False, True):
            kernel_ms = time_ms(
                lambda: kernel.ff_dense(x, w, b, norm=norm), flush)
            plain_ms = time_ms(
                lambda: kernel.ff_dense_plain(x, w, b, norm=norm), flush)
            bound_ms, bound_by = bound(M, K, N, norm)
            max_err, max_abs_err = errs[(M, K, N, norm)]
            rows.append({
                "name": "ff_dense", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "shape": [M, K, N], "norm": norm, "dtype": "float32",
                "launches": None, "max_abs_err": max_abs_err,
                "max_err": max_err, "ms": kernel_ms,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "library": "torch.addmm(b, x, w), TF32 off: matmul only"})
            print(f"[4 time] ff_dense {(M, K, N)} norm={norm}: kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, addmm "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})")
    del flush

    # 5. whole path at full width ------------------------------------------
    pgen = torch.Generator().manual_seed(PAPER_MLP.seed)
    p_sumsq = ff_mlp.init(PAPER_MLP, pgen, "cuda")
    cfg_po = dataclasses.replace(PAPER_MLP, goodness_fn="perf_opt",
                                 classifier="perf_opt_all")
    p_po = ff_mlp.init(cfg_po, pgen, "cuda")
    task = data.mnist_like(seed=0, n_train=64, n_test=1000)
    xb = torch.as_tensor(task.x_test[:64], device="cuda")
    for mode, params in (("goodness", p_sumsq), ("softmax", p_sumsq),
                         ("perf_opt_all", p_po)):
        before = kernel.LAUNCHES
        s_k = ff_mlp.class_scores(params, xb, PAPER_MLP.num_classes, mode,
                                  impl="auto")
        s_r = ff_mlp.class_scores(params, xb, PAPER_MLP.num_classes, mode,
                                  impl="ref")
        torch.cuda.synchronize()
        check(kernel.LAUNCHES - before == len(params["layers"]),
              f"{mode}: impl='auto' did not run the kernel once per layer")
        check(s_k.shape == (64, PAPER_MLP.num_classes)
              and bool(torch.isfinite(s_k).all()),
              f"{mode}: scores not finite or of the wrong shape")
        err = scaled_err(s_k, s_r)
        decided = top2_margin(s_r) > PATH_TOL * s_r.abs().max()
        agree = bool((s_k.argmax(1) == s_r.argmax(1))[decided].all())
        print(f"[5 path] PAPER_MLP {mode}: scores err {err:.3e} "
              f"(<= {PATH_TOL}), predictions agree on "
              f"{int(decided.sum())}/64 decided rows: {agree}")
        check(err <= PATH_TOL and agree,
              f"{mode}: kernel path disagrees with the plain path")

    # 6. serving: the main path --------------------------------------------
    kernel.LAUNCHES = 0
    res = api.serve(PAPER_MLP, task, params=p_sumsq, traffic="uniform",
                    n_requests=SERVE_REQUESTS, rate=2000.0, max_batch=64)
    launches = kernel.LAUNCHES
    batches = res.raw.batches_scored
    slo = res.slo
    print(json.dumps({"slo": slo, "batches_scored": batches,
                      "ff_dense_launches": launches}))
    check(slo["requests"] == SERVE_REQUESTS and slo["rejected"] == 0
          and all(r["pred"] is not None for r in res.records),
          "not every request was scored")
    check(slo["consistency_violations"] == 0, "consistency violations")
    check(launches > 0 and launches == 4 * batches,
          f"ff_dense launches {launches} != 4 x {batches} scored batches")
    # the served predictions against the plain path on the same payloads
    xs = np.stack([r.x for r in res.raw.requests])
    served = torch.tensor([r.pred for r in res.raw.requests])
    s_ref = ff_mlp.chunked_scores(
        lambda xc: ff_mlp.class_scores(p_sumsq, xc, PAPER_MLP.num_classes,
                                       "goodness", impl="ref"),
        xs, chunk=64, device="cuda").cpu()
    decided = top2_margin(s_ref) > PATH_TOL * s_ref.abs().max()
    check(bool((served == s_ref.argmax(1))[decided].all()),
          "served predictions disagree with the plain path")
    print(f"[6 serve] {SERVE_REQUESTS} requests in {batches} batches, "
          f"{launches} ff_dense calls ({2 * launches} CUDA launches); "
          f"served predictions match the plain path on "
          f"{int(decided.sum())} decided requests")
    for row in rows:
        row["launches"] = launches

    # 7. backward kernel against its plain version -------------------------
    bwd_errs = {}
    for M, K, N in BWD_CHECK_SHAPES:
        x, w, y, dy_out, dg = bwd_inputs(gen, M, K, N)
        out = vjp.ff_dense_bwd(x, w, y, dy_out, dg)
        torch.cuda.synchronize()
        ref = vjp.ff_dense_bwd_plain(x, w, y, dy_out, dg)
        torch.cuda.synchronize()
        for t, r, name in zip(out, ref, ("dx", "dw", "db")):
            check(t.shape == r.shape and t.dtype == torch.float32
                  and bool(torch.isfinite(t).all()),
                  f"ff_dense_bwd {name} shape/type/finite at {(M, K, N)}")
        e = [scaled_err(t, r) for t, r in zip(out, ref)]
        bwd_errs[(M, K, N)] = max(float((t - r).abs().max())
                                  for t, r in zip(out, ref))
        print(f"[7 check] ff_dense_bwd {(M, K, N)}: dx err {e[0]:.3e}, "
              f"dw err {e[1]:.3e}, db err {e[2]:.3e} (<= {GRAD_TOL})")
        check(max(e) <= GRAD_TOL, f"ff_dense_bwd disagrees with its plain "
              f"version at {(M, K, N)}")
    x, w, y, dy_out, dg = bwd_inputs(torch.Generator().manual_seed(7),
                                     *TRAIN_SHAPES[1])
    first = vjp.ff_dense_bwd(x, w, y, dy_out, dg)
    again = vjp.ff_dense_bwd(x, w, y, dy_out, dg)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"ff_dense_bwd: two calls at {TRAIN_SHAPES[1]} differ")
    print(f"[7 check] ff_dense_bwd {TRAIN_SHAPES[1]}: a second call gives "
          f"bit-identical dx, dw, db")
    x, w, y, dy_out, dg = bwd_inputs(gen, 64, 784, 2000, dead_row=True)
    dx, dw, db = vjp.ff_dense_bwd(x, w, y, dy_out, dg)
    torch.cuda.synchronize()
    check(bool((y[0] == 0).all()), "the dead-row case has a live unit")
    check(all(bool(torch.isfinite(t).all()) for t in (dx, dw, db)),
          "NaN dg on a dead row leaked into the backward's outputs")
    check(bool((dx[0] == 0).all()), "the dead row's dx is not zero")
    print("[7 check] dead row with dg = NaN: dx, dw, db finite, dead "
          "row's dx == 0")

    # 8. gradients through the autograd Functions --------------------------
    for M, K, N in [(128, 2000, 2000), (64, 2000, 2000)]:
        x, w, b = make_inputs(gen, M, K, N, torch.float32)
        v = torch.randn(N, generator=gen).cuda()
        cases = [
            ("ff_dense_vjp, _stacked_ff_loss peer_w=0.3",
             stacked_ff_loss(vjp.ff_dense_vjp, 0.3),
             stacked_ff_loss(lambda *a: kernel.ff_dense_plain(*a), 0.3)),
            ("ff_dense_norm_vjp, _normed_loss",
             normed_loss(vjp.ff_dense_norm_vjp, v),
             normed_loss(lambda *a: kernel.ff_dense_plain(*a, norm=True),
                         v)),
        ]
        for name, fused, plain in cases:
            before = vjp.LAUNCHES
            gk = grads(fused, x, w, b)
            torch.cuda.synchronize()
            check(vjp.LAUNCHES - before == 1,
                  f"{name}: the backward kernel did not run once")
            gp = grads(plain, x, w, b)
            e = [scaled_err(a, r) for a, r in zip(gk, gp)]
            print(f"[8 grad] {name} {(M, K, N)}: dx {e[0]:.3e}, dw "
                  f"{e[1]:.3e}, db {e[2]:.3e} (<= {GRAD_TOL})")
            check(max(e) <= GRAD_TOL, f"{name} at {(M, K, N)} disagrees "
                  f"with autograd of the plain version")

    # 9. timing: backward (and forward) at the training shapes -------------
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    bwd_rows, fwd_rows = [], []
    for M, K, N in TRAIN_SHAPES:
        x, w, y, dy_out, dg = bwd_inputs(gen, M, K, N)
        dy = torch.where(y > 0, dy_out + 2.0 * y * dg[:, None],
                         torch.zeros((), device="cuda"))

        def library():
            return torch.mm(dy, w.T), torch.mm(x.T, dy), dy.sum(0)
        kernel_ms = time_ms(lambda: vjp.ff_dense_bwd(x, w, y, dy_out, dg),
                            flush)
        plain_ms = time_ms(
            lambda: vjp.ff_dense_bwd_plain(x, w, y, dy_out, dg), flush)
        library_ms = time_ms(library, flush)
        bound_ms, bound_by = bwd_bound(M, K, N)
        bwd_rows.append({
            "name": "ff_dense_bwd", "route": "cuda", "source": BWD_SOURCE,
            "replaces": BWD_REPLACES, "shape": [M, K, N],
            "dtype": "float32", "launches": None,
            "max_abs_err": bwd_errs[(M, K, N)], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "torch.mm(dy, w.T) + torch.mm(x.T, dy) + "
                       "dy.sum(0) on a precomputed dy, TF32 off"})
        print(f"[9 time] ff_dense_bwd {(M, K, N)}: kernel {kernel_ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by})")
        if (M, K, N) == TRAIN_SHAPES[1]:
            parts = {name: time_ms(lambda: vjp._launch(x, w, y, dy_out, dg,
                                                       bit), flush)
                     for name, bit in (("grad_x", vjp.GRAD_X),
                                       ("split-sum", vjp.SUM_SLICES),
                                       ("grad_w", vjp.GRAD_W))}
            bwd_rows[-1]["parts_ms"] = parts
            print(f"[9 time] ff_dense_bwd {(M, K, N)} by launch (each alone, "
                  f"cold L2; {vjp._grad_x_split(M, K, N)[0]} slices): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
    for M, K, N in TRAIN_SHAPES[:2]:
        x, w, b = make_inputs(gen, M, K, N, torch.float32)
        y, g = kernel.ff_dense(x, w, b)
        yp, gp = kernel.ff_dense_plain(x, w, b)
        max_abs_err = float(max((y - yp).abs().max(), (g - gp).abs().max()))
        kernel_ms = time_ms(lambda: kernel.ff_dense(x, w, b), flush)
        plain_ms = time_ms(lambda: kernel.ff_dense_plain(x, w, b), flush)
        library_ms = time_ms(lambda: torch.addmm(b, x, w), flush)
        bound_ms, bound_by = bound(M, K, N, False)
        fwd_rows.append({
            "name": "ff_dense", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES, "shape": [M, K, N], "norm": False,
            "dtype": "float32", "launches": None,
            "max_abs_err": max_abs_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "torch.addmm(b, x, w), TF32 off: matmul only"})
        print(f"[9 time] ff_dense {(M, K, N)} (training M): kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, addmm "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # One sumsq grad step at (128, 2000, 2000), the training shape of
    # layers 1-3: device time of Adam's update (the kernels' are above),
    # and the wall time of 50 steps run back to back.
    M, K, N = TRAIN_SHAPES[1]
    xb = ff_mlp._norm(torch.randn(M, K, generator=gen)).cuda()
    lp = {"w": (torch.randn(K, N, generator=gen) * K ** -0.5).cuda(),
          "b": torch.zeros(N, device="cuda")}
    opt, lr0 = optim.adam_init(lp), torch.tensor(1e-3)

    def step():
        g = ff_mlp._grad(ff_mlp._ff_layer_loss, lp, xb, 2.0, 0.0, "auto")
        optim.adam_update(lp, g, opt, lr=lr0, step=1)
        return g
    g_step = step()
    adam_ms = time_ms(
        lambda: optim.adam_update(lp, g_step, opt, lr=lr0, step=1), flush)
    step_dev_ms = time_ms(step, flush, spin=STEP_SPIN_CYCLES)
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"[9 step] sumsq grad step {(M, K, N)}: {step_ms:.4f} ms wall "
          f"per step over 50 (host enqueue {enqueue_ms:.4f} ms); one step's "
          f"device time {step_dev_ms:.4f} ms (cold L2); Adam update "
          f"{adam_ms:.4f} ms on the card; kernels: forward "
          f"{fwd_rows[1]['ms']:.4f} ms + backward {bwd_rows[1]['ms']:.4f} "
          f"ms (cold L2)")
    del flush

    # 10. trainer parity: kernels vs the plain path, one key ----------------
    # Inputs are length-normalized rows, as every layer's inputs are in
    # training (ff_mlp._norm, the norm=True epilogue).
    n, lrs = 1024, torch.full((1,), 0.01)
    tgen = torch.Generator().manual_seed(1)
    K, N = 784, 2000
    xs = [ff_mlp._norm(torch.randn(n, K, generator=tgen)).cuda()
          for _ in range(2)]
    w0 = torch.randn(K, N, generator=tgen) * K ** -0.5
    out = {}
    for impl in ("auto", "ref"):
        lp = {"w": w0.clone().cuda(), "b": torch.zeros(N, device="cuda")}
        before = vjp.LAUNCHES
        ff_mlp.train_layer_chapter(
            lp, optim.adam_init(lp), xs[0], xs[1], lrs, TorchKey(5),
            batch=64, epochs=1, theta=2.0, peer_w=0.0, impl=impl)
        out[impl] = (lp, vjp.LAUNCHES - before)
    check(out["auto"][1] == n // 64 and out["ref"][1] == 0,
          f"train_layer_chapter backward launches {out['auto'][1]} / "
          f"{out['ref'][1]}, expected {n // 64} / 0")
    err = max(float((out["auto"][0][k] - out["ref"][0][k]).abs().max())
              for k in ("w", "b"))
    print(f"[10 trainer] train_layer_chapter (n={n}, K={K}, N={N}, 1 "
          f"epoch): kernel vs plain weights max-abs {err:.3e} "
          f"(<= {WEIGHT_TOL})")
    check(err <= WEIGHT_TOL, "train_layer_chapter: kernel and plain "
          "weight streams diverge")
    # The perf_opt gradient is discontinuous at the relu boundary: dy =
    # dyn * u does not vanish as y -> 0 (sumsq's 2 y dg does). Where two
    # f32 summation orders put a pre-activation on opposite sides of 0,
    # the two paths take different Adam steps on that unit's column. So
    # the gated run starts from biases of 0.5, which keep pre-activations
    # (std ~0.02 on normalized rows) far from the boundary even after 16
    # Adam steps of ~lr = 0.01 each; the run from b = 0 is printed, not
    # gated. The relu mask itself is held in phases 7 and 8.
    K = N = 2000
    x = ff_mlp._norm(torch.randn(n, K, generator=tgen)).cuda()
    yl = torch.randint(0, 10, (n,), generator=tgen).cuda()
    w0 = torch.randn(K, N, generator=tgen) * K ** -0.5
    h0 = torch.randn(N, 10, generator=tgen) * N ** -0.5
    for b0 in (0.0, 0.5):
        for impl in ("auto", "ref"):
            lp = {"w": w0.clone().cuda(),
                  "b": torch.full((N,), b0, device="cuda")}
            head = {"w": h0.clone().cuda(),
                    "b": torch.zeros(10, device="cuda")}
            ff_mlp.train_layer_chapter_perf_opt(
                lp, head, optim.adam_init(lp), optim.adam_init(head), x,
                yl, lrs, TorchKey(6), batch=64, epochs=1, impl=impl)
            out[impl] = (lp, head)
        err = max(float((out["auto"][i][k] - out["ref"][i][k]).abs().max())
                  for i in (0, 1) for k in ("w", "b"))
        dw = (out["auto"][0]["w"] - out["ref"][0]["w"]).abs()
        units = int((dw > WEIGHT_TOL).any(dim=0).sum())
        print(f"[10 trainer] train_layer_chapter_perf_opt (n={n}, K=N={N}, "
              f"1 epoch, b0={b0}): kernel vs plain weights max-abs "
              f"{err:.3e}, {int((dw > WEIGHT_TOL).sum())} weights in "
              f"{units} units beyond {WEIGHT_TOL}"
              + (f" (gated: <= {WEIGHT_TOL})" if b0 else " (not gated)"))
    check(err <= WEIGHT_TOL, "train_layer_chapter_perf_opt: kernel and "
          "plain weight streams diverge")

    # 11. training at full width: the main path ----------------------------
    fit_task = data.mnist_like(seed=0, n_train=FIT_TRAIN, n_test=FIT_TEST)
    base = dataclasses.replace(PAPER_MLP, epochs=2, splits=2)
    n_layers = len(base.layer_sizes) - 1
    grad_steps = (base.splits * n_layers * (base.epochs // base.splits)
                  * -(-FIT_TRAIN // base.batch_size))
    p0 = ff_mlp.init(base, TorchKey(base.seed), "cuda")
    train_launches = {}
    for label, cfg in (
            ("adaptive negatives, goodness", base),
            ("perf_opt goodness, perf_opt_all",
             dataclasses.replace(base, goodness_fn="perf_opt",
                                 classifier="perf_opt_all"))):
        kernel.LAUNCHES = 0
        vjp.LAUNCHES = 0
        t0 = time.perf_counter()
        res = api.fit(cfg, fit_task, backend="sequential")
        fit_s = time.perf_counter() - t0
        fwd_calls, bwd_calls = kernel.LAUNCHES, vjp.LAUNCHES
        train_launches["fwd"] = train_launches.get("fwd", 0) + fwd_calls
        train_launches["bwd"] = train_launches.get("bwd", 0) + bwd_calls
        t0 = time.perf_counter()
        res_ref = api.fit(dataclasses.replace(cfg, kernel_impl="ref"),
                          fit_task, backend="sequential")
        ref_s = time.perf_counter() - t0
        leaves = [lp[k] for lp in res.params["layers"] for k in ("w", "b")]
        check(all(bool(torch.isfinite(t).all()) for t in leaves),
              f"{label}: non-finite params after the fit")
        moved = float((res.params["layers"][0]["w"]
                       - p0["layers"][0]["w"]).abs().max())
        check(moved > 0, f"{label}: the first layer did not move")
        check(bwd_calls == grad_steps,
              f"{label}: {bwd_calls} backward kernel calls for "
              f"{grad_steps} grad steps")
        check(fwd_calls >= grad_steps,
              f"{label}: {fwd_calls} forward kernel calls")
        check(abs(res.test_acc - res_ref.test_acc) <= ACC_BAND,
              f"{label}: test_acc {res.test_acc} (kernels) vs "
              f"{res_ref.test_acc} (plain)")
        sim = api.simulate(res, "all_layers", 4)
        print(f"[11 fit] PAPER_MLP {label}: test_acc {res.test_acc:.4f} "
              f"(plain path {res_ref.test_acc:.4f}), train_acc "
              f"{res.train_acc:.4f}; {bwd_calls} backward calls "
              f"({3 * bwd_calls} CUDA launches) for {grad_steps} grad "
              f"steps, {fwd_calls} forward calls; fit {fit_s:.3f} s "
              f"(plain path {ref_s:.3f} s)")
        print(json.dumps({"fit": label, "task_s": [
            [r.kind, r.layer, r.chapter, r.duration] for r in res.records],
            "plain_task_s": [[r.kind, r.layer, r.chapter, r.duration]
                             for r in res_ref.records]}))
        print(f"[11 fit] all_layers speedup on 4 nodes {sim.speedup:.4f}, "
              f"utilization {sim.utilization:.4f}: simulated from H100 "
              f"task times, not run on 4 cards")
    for row in bwd_rows:
        row["launches"] = train_launches["bwd"]
    for row in fwd_rows:
        row["launches"] = train_launches["fwd"]
    rows += fwd_rows + bwd_rows

    # 12. attention kernel against its plain version ----------------------
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    fa_errs = {}
    for B, Sq, Sk, H, KV, hd, causal, window in FA_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = fa_inputs(gen, B, Sq, Sk, H, KV, hd, dtype)
            o = fa.flash_attention(q, k, v, causal=causal, window=window)
            again = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(torch.equal(o, again), f"flash_attention: two calls at "
                  f"{(B, Sq, Sk, H, KV, hd, causal, window)} {dtype} differ")
            p = fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            check(o.dtype == dtype and o.shape == q.shape
                  and bool(torch.isfinite(o.float()).all()),
                  f"flash_attention output type/shape/finite at {(B, Sq, Sk)}")
            e = scaled_err(o, p)
            shape = (B, Sq, Sk, H, KV, hd, causal, window)
            diff = (o.float() - p.float()).abs()
            fa_errs[shape + (dtype,)] = float(diff.max())
            msg = ""
            if dtype == torch.bfloat16:
                # worst |o - p| over its elementwise limit (<= 1 passes)
                lim = (FA_BF16_REL * p.float().abs()
                       + FA_BF16_ABS * p.float().abs().max())
                r = float((diff / lim).max())
                msg = (f"; elementwise {r:.3f} of 2^-7 |p| + "
                       f"{FA_BF16_ABS} max|p| (<= 1)")
                check(r <= 1.0, f"flash_attention bf16 differs from its "
                      f"plain version by more than one bf16 rounding at "
                      f"{shape}")
            print(f"[12 check] flash_attention {shape} {str(dtype)[6:]}: err "
                  f"{e:.3e} (<= {FA_TOL[dtype]}){msg}; repeat bit-identical")
            check(e <= FA_TOL[dtype], f"flash_attention disagrees with its "
                  f"plain version at {shape} {dtype}")
            del q, k, v, o, again, p

    # 13. SSD kernel against its plain version ----------------------------
    ssd_errs = {}
    for B, S, H, hd, N, chunk, decay in SSD_CHECKS:
        xbar, dA, b, c = ssd_inputs(gen, B, S, H, hd, N, decay)
        y, hT = ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk)
        torch.cuda.synchronize()
        yp, hp = ssd.mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk)
        check(y.shape == yp.shape and hT.shape == hp.shape
              and bool(torch.isfinite(y).all() and torch.isfinite(hT).all()),
              f"mamba2_ssd output shape/finite at {(B, S, H, hd, N, chunk)}")
        ey, eh = scaled_err(y, yp), scaled_err(hT, hp)
        shape = (B, S, H, hd, N, chunk)
        ssd_errs[shape + (decay,)] = float(max((y - yp).abs().max(),
                                               (hT - hp).abs().max()))
        print(f"[13 check] mamba2_ssd {shape} {decay} decay: y err {ey:.3e}, "
              f"hT err {eh:.3e} (<= {SSD_TOL})")
        check(max(ey, eh) <= SSD_TOL, f"mamba2_ssd disagrees with its plain "
              f"version at {shape} ({decay} decay)")
        del xbar, dA, b, c, y, hT, yp, hp

    # 14. timing of both beside their bounds -----------------------------
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    lm_rows = []
    B, Sq, Sk, H, KV, hd, causal, window = QWEN_ATTN
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = fa_inputs(gen, B, Sq, Sk, H, KV, hd, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v), flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v), flush)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        bound_ms, bound_by = roofline(*fa_bound(B, Sq, Sk, H, KV, hd, causal,
                                                dtype))
        lm_rows.append({
            "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
            "replaces": FA_REPLACES, "shape": [B, Sq, Sk, H, KV, hd],
            "causal": True, "dtype": str(dtype)[6:], "launches": None,
            "max_abs_err": fa_errs[QWEN_ATTN + (dtype,)], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True) on (B, H, S, hd) copies, TF32 off"})
        print(f"[14 time] flash_attention {QWEN_ATTN} {str(dtype)[6:]}: "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del q, k, v, qt, kt, vt
    B, S, H, hd, N, chunk = MAMBA_SSD
    xbar, dA, b, c = ssd_inputs(gen, B, S, H, hd, N, "mild")
    kernel_ms = time_ms(lambda: ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk),
                        flush)
    plain_ms = time_ms(
        lambda: ssd.mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk), flush)
    bound_ms, bound_by = roofline(*ssd_bound(B, S, H, hd, N, chunk))
    lm_rows.append({
        "name": "mamba2_ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "shape": [B, S, H, hd, N, chunk],
        "dtype": "float32", "launches": None,
        "max_abs_err": ssd_errs[MAMBA_SSD + ("mild",)], "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan"})
    print(f"[14 time] mamba2_ssd {MAMBA_SSD}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"no library call computes the scan")
    del xbar, dA, b, c, flush

    # 15. LM serving at full width and depth: the main path ---------------
    # Each model in bf16: one short warm-up run per path (first-use costs
    # of cuBLAS's kernels and ours), then the main path through the
    # kernels with every count zeroed just before and read just after,
    # then plain, plain, kernels again (times compared in turns). Logits
    # are compared over the real vocab: the padded rows are -1e30.
    def run_lm(cfg, params, impl, gen=LM_GEN):
        return lm_decode(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=gen,
                         seed=0, params=params, impl=impl)

    def times(res):
        return {k: res[k] for k in ("prefill_s", "decode_s",
                                    "decode_tok_per_s")}

    lm_launches = {}
    for name, (op, calls) in LM_CALLS.items():
        cfg = get_config(name)
        counter = fa if op == "flash_attention" else ssd
        other = ssd if counter is fa else fa
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        for impl in ("auto", "ref"):
            run_lm(cfg, params, impl, gen=2)
        fa.LAUNCHES = ssd.LAUNCHES = 0
        res = run_lm(cfg, params, "auto")
        launches = counter.LAUNCHES
        lm_launches[op] = launches
        check(launches == calls and other.LAUNCHES == 0,
              f"{name}: lm_decode made {launches} {op} kernel calls (and "
              f"{other.LAUNCHES} of the other op), expected {calls} and 0")
        res_ref = run_lm(cfg, params, "ref")
        res_ref2 = run_lm(cfg, params, "ref")
        res2 = run_lm(cfg, params, "auto")
        check(counter.LAUNCHES == 2 * calls and other.LAUNCHES == 0,
              f"{name}: impl='ref' launched a kernel, or a kernel run did "
              f"not launch {calls}")
        gk, gr = res["generated"], res_ref["generated"]
        check(gk.shape == (LM_BATCH, LM_GEN) and bool(
            ((gk >= 0) & (gk < cfg.vocab)).all()),
              f"{name}: generated tokens of the wrong shape or range")
        check(torch.equal(gk, res2["generated"])
              and torch.equal(gr, res_ref2["generated"]),
              f"{name}: two runs of one path generated different tokens")
        agree = float((gk == gr).float().mean())
        first = int((gk[:, 0] == gr[:, 0]).sum())
        # the prefill alone, each path: kernel calls, logits, and decode
        prompts = torch.as_tensor(next(iter(data.lm_batches(
            cfg.vocab, LM_BATCH, LM_PROMPT - 1, 1, 0))), device="cuda")
        with torch.no_grad():
            fa.LAUNCHES = ssd.LAUNCHES = 0
            lk, caches = transformer.prefill(params, cfg, prompts,
                                             max_len=LM_PROMPT + LM_GEN,
                                             last_only=True)
            check(counter.LAUNCHES == calls,
                  f"{name}: prefill made {counter.LAUNCHES} kernel calls")
            tok = lk.argmax(-1)
            for i in range(3):
                _, caches = transformer.serve_step(params, cfg, caches, tok,
                                                   LM_PROMPT + i)
            torch.cuda.synchronize()
            check(fa.LAUNCHES + ssd.LAUNCHES == calls,
                  f"{name}: decode launched a kernel")
            lr, _ = transformer.prefill(params, cfg, prompts,
                                        max_len=LM_PROMPT + LM_GEN,
                                        last_only=True, impl="ref")
        lk, lr = lk[:, :cfg.vocab], lr[:, :cfg.vocab]
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        e = scaled_err(lk, lr)
        print(f"[15 lm] {name} bf16 (B {LM_BATCH}, prompt {LM_PROMPT}, gen "
              f"{LM_GEN}): {launches} {op} calls in prefill, 0 in decode; "
              f"last-position prefill logits kernel vs plain err {e:.3e} "
              f"(<= {LM_BF16_TOL}); greedy tokens agree {agree:.4f} (first "
              f"token {first}/{LM_BATCH}, top-2 margins of the plain path "
              f"{[round(float(m), 4) for m in top2_margin(lr)]})")
        print(f"[15 lm] {name} bf16 prefill s, kernel / plain / plain / "
              f"kernel: {res['prefill_s']:.4f} / {res_ref['prefill_s']:.4f} "
              f"/ {res_ref2['prefill_s']:.4f} / {res2['prefill_s']:.4f}; "
              f"decode tok/s {res['decode_tok_per_s']:.2f} / "
              f"{res_ref['decode_tok_per_s']:.2f} / "
              f"{res_ref2['decode_tok_per_s']:.2f} / "
              f"{res2['decode_tok_per_s']:.2f}")
        print(json.dumps({"lm": name, "dtype": "bfloat16",
                          "kernel": [times(res), times(res2)],
                          "plain": [times(res_ref), times(res_ref2)],
                          "kernel_calls": launches, "logit_err": e,
                          "token_agreement": agree}))
        check(e <= LM_BF16_TOL, f"{name}: prefill logits, kernel path vs "
              f"plain path, {e} > {LM_BF16_TOL}")
        del params, caches, res, res2, res_ref, res_ref2

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg32)
        for impl in ("auto", "ref"):
            run_lm(cfg32, p32, impl, gen=2)
        res = run_lm(cfg32, p32, "auto")
        res_ref = run_lm(cfg32, p32, "ref")
        with torch.no_grad():
            lk, _ = transformer.prefill(p32, cfg32, prompts, last_only=True)
            lr, _ = transformer.prefill(p32, cfg32, prompts, last_only=True,
                                        impl="ref")
        lk, lr = lk[:, :cfg.vocab], lr[:, :cfg.vocab]
        decided = top2_margin(lr) > F32_MARGIN
        same = res["generated"][:, 0] == res_ref["generated"][:, 0]
        e = scaled_err(lk, lr)
        print(f"[15 lm] {name} f32: last-position prefill logits kernel vs "
              f"plain err {e:.3e} (<= {PATH_TOL}); first token equal on "
              f"{int(same[decided].sum())}/{int(decided.sum())} rows with "
              f"top-2 margin > {F32_MARGIN}; greedy tokens agree "
              f"{float((res['generated'] == res_ref['generated']).float().mean()):.4f}"
              f"; prefill s kernel / plain {res['prefill_s']:.4f} / "
              f"{res_ref['prefill_s']:.4f}; decode tok/s "
              f"{res['decode_tok_per_s']:.2f} / "
              f"{res_ref['decode_tok_per_s']:.2f}")
        check(e <= PATH_TOL, f"{name} f32: prefill logits, kernel path vs "
              f"plain path, {e} > {PATH_TOL}")
        check(bool(same[decided].all()), f"{name} f32: first generated "
              f"tokens differ from the plain path on decided rows")
        del p32, res, res_ref
        torch.cuda.empty_cache()
    for row in lm_rows:
        row["launches"] = lm_launches[row["name"]]
    rows += lm_rows

    # 16. isolation --------------------------------------------------------
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not leaked, f"JAX or the JAX package was imported: {leaked}")
    print("[16 isolation] no jax, no repro module loaded")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
