#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (``src/repro_torch``) starts and is
right on an NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``.
Phases, in order; any failure ends the run with a non-zero exit:

1. Device: the card's name and power limit (``nvidia-smi``).
2. Build: ``nvcc`` builds the kernel library from ``kernels/csrc``;
   each kernel's registers, shared memory and spills (``ptxas -v``), and
   the tensor-core instructions in the 3xTF32 kernels' SASS.
3. Kernel against its plain version, on the card: ``ff_dense`` at the
   serving shapes and two ragged ones, norm off/on, f32 and bf16, plus a
   row forced all-dead. Errors are scaled by max |plain|. A second call
   at (128, 2000, 2000) and (640, 2000, 2000) must give bit-identical
   outputs, and is held against a float64 truth beside the plain version.
4. Timing (CUDA events, L2 flushed before each call, median of 25; a
   spin kernel ahead of each call keeps host enqueue time out) of the
   kernel, its plain version and ``torch.addmm`` at the serving shapes,
   beside the least time the card could take (``bound_ms``); the kernel
   at each block width it is built for.
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
   four training shapes, norm off and on (y and g gated as in phase 3),
   each of its two launches (gemm_split, finish_rows) alone and each
   block width, beside the plain version, the library yardstick and the
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
    G = 1 at hd 128, Sq != Sk non-causal, rows that see no key, the
    LM-training shapes (4, 8 and 16 rows of 256), the qwen3-8b,
    h2o-danube-3-4b (hd 120, window 4096) and recurrentgemma-2b (hd 256,
    MQA, window 2048) prefill shapes, two ragged ones at hd 120 and
    256, and the deepseek-moe-16b (MHA, 16/16 heads) and
    qwen3-moe-235b-a22b (GQA of 16, 64/4 heads) prefill shapes at hd 128;
    a second call must give bit-identical outputs.
13. SSD kernel against its plain version: ``mamba2_ssd`` at the
    mamba2-780m prefill shape (strong and mild decay), a ragged S,
    chunk 128, and the LM-training shapes (4, 8 and 16 rows of S = chunk
    = 256: one chunk); a second call at the prefill shape must give
    bit-identical outputs.
14. Timing of both (CUDA events, L2 flushed) beside the plain versions,
    the bound and, for attention, ``F.scaled_dot_product_attention``, at
    the six attention prefill shapes (qwen2-0.5b, qwen3-8b,
    h2o-danube-3-4b, recurrentgemma-2b, deepseek-moe-16b,
    qwen3-moe-235b-a22b); each of the SSD's four launches alone.
15. LM serving, the main path: ``launch.serve.lm_decode`` of qwen2-0.5b
    and mamba2-780m at full width and depth (random weights from seed 0,
    batch 4, prompt 2048, 32 tokens) in bf16 through the kernels and
    through the plain path; 24 attention / 48 SSD kernel calls per
    prefill, none in decode; last-position prefill logits gated against
    the plain path; then once in f32, first tokens equal where decided.
16. The SSD kernel at the reduced mamba2-780m sizes (chunk 32, hd 32,
    N 16, ragged S) against its plain version, a bit-identical repeat,
    its time; ``lm_decode`` of the reduced config on the card, its SSD
    calls counted, prefill logits and first tokens against the plain path.
17. The PFF executor, the paper's claim: ``api.fit(backend="executor")``
    of ``PAPER_MLP`` (full width, 4 epochs in 4 chapters, the phase-11
    task) on 4 nodes, 4 CUDA streams of the card: all_layers with the
    double-buffered hand-off on and off, single_layer, and federated
    against the federated backend, each bit-identical to its sequential
    counterpart, with kernel calls counted against it; the makespan
    beside the sequential fit and the simulator's prediction; one traced
    run through ``obs.analyze.check_invariants``.
18. Resilience at the same config: a crash retried, a dead node
    reassigned, chapter checkpoints written and resumed from, all
    bit-identical; a kill-then-resume pair through
    ``python -m repro_torch.core.pff_exec --device cuda``.
19. Train-while-serve: ``api.serve`` without ``params=`` trains the
    phase-17 cell (all_layers, 4 streams) on a ``pff-train`` thread and
    serves uniform traffic at 2000 req/s from its bus on a stream of its
    own meanwhile: 0 consistency violations, swap versions [-1, 0, 1, 2,
    3], >= 128 requests at the final version, params bit-identical to
    phase 17's all_layers run; the final version's served predictions
    equal to a replica's re-scoring and to the plain path's argmax where
    the top-2 margin exceeds twice the kernel-vs-plain score error; the
    served model's test accuracy above the untrained model's (the
    served windows' accuracy by version printed); kernel calls counted
    per thread.
20. Repair: the attention and SSD kernels refuse inputs that need a
    gradient and launch under no_grad; ``impl="ref"`` gives the grads of
    wq/wk/wv and A_log/dt_bias/in_proj.
21. LM chapter training of qwen2-0.5b at full width and depth (bf16, 2
    chapters x 2 steps, batch 4, seq 256 of the BPE text source):
    sequential, the executor's all_layers and single_layer on 4 streams
    (bit-identical, equal eval CE), the plain route; 1224 attention
    kernel calls per kernel-routed fit, 0 plain; eval CE below the
    untrained model's and within 5e-2 of the plain-routed fit's; the
    sequential fit's params scored through the kernels and the plain
    route within 1e-3, below a control (the last block's mixer
    dropped). Two joint-FF
    steps and one AdaptiveNEG step (24 kernel calls in its no-grad
    forward).
22. The same for mamba2-780m (1 chapter, sequential and plain): 2400
    SSD kernel calls, and the same eval CE gates.
23. LM families, the main path of the dense and hybrid configs:
    ``lm_decode`` of tinyllama-1.1b, qwen3-8b, h2o-danube-3-4b and
    recurrentgemma-2b at published widths and depth (random weights from
    seed 0, bf16, batch 4, prompts of 2048 / 2048 / 4608 / 4096 tokens,
    32 tokens) through the kernels and through the plain path: 22 / 36 /
    24 / 8 attention kernel calls per prefill, none in decode;
    last-position prefill logits within ``LM_BF16_TOL`` of the plain
    path, first tokens equal where its top-2 margin decides them; then
    in f32 at full width and one unit of each group pattern, logits
    within ``PATH_TOL`` and first tokens equal on decided rows.
24. The reduced h2o-danube-3-4b and recurrentgemma-2b served on the card
    (prompts past their windows of 64 and 32, so the rings wrap): kernel
    calls, prefill logits and first tokens against the plain path.
25. The MoE configs, the main path: ``lm_decode`` of deepseek-moe-16b
    (published widths and depth) and qwen3-moe-235b-a22b (published
    widths, 10 of its 94 blocks) in bf16 (random weights from seed 0,
    batch 4, prompt 2048, 32 tokens) through the kernels and through the
    plain path: 28 / 10 attention kernel calls per prefill, none in
    decode, no SSD calls; prefill time and decode step time beside their
    bounds. Then ``moe_gate``: with the router's choices pinned to the
    plain route's, last-position prefill logits within ``LM_BF16_TOL``
    and first tokens equal on decided rows; free-running, the logits,
    the (token, slot) and expert-set agreement of the routes per block
    and the pairs dropped past capacity, each route, printed beside a
    control (the plain route with attention moved one step at one in
    ten outputs). Then in f32 at one block, within ``PATH_TOL``.
26. The reduced deepseek-moe-16b and qwen3-moe-235b-a22b on the card at
    ``REDUCED_LM`` (T = 800: the MoE's sorted branch) and at a 32-token
    prompt (T = 128: its dense-local branch): kernel calls, then
    ``moe_gate`` within ``PATH_TOL``.
27. Isolation: no ``jax`` and no ``repro`` module was loaded.

Phases 17-19 and 21's fits run under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, set before CUDA starts.

The second-to-last line is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM published peaks: f32 outside the tensor cores, bf16 and TF32
# dense on the tensor cores, and HBM bandwidth.
F32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
TF32_PEAK_FLOPS = 495e12
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
# LM chapter training (phases 21-22) at seq 256 calls the kernels on the
# head task's 4 rows, the frozen prefixes' 8 (positives and negatives)
# and eval's 16
LM_TRAIN_ROWS = (4, 8, 16)
# the qwen3-8b, h2o-danube-3-4b (its window bites at S 4608) and
# recurrentgemma-2b (local attention, MQA) prefills of phase 23
QWEN3_ATTN = (4, 2048, 2048, 32, 8, 128, True, None)
DANUBE_ATTN = (4, 4608, 4608, 32, 8, 120, True, 4096)
RG_ATTN = (4, 4096, 4096, 10, 1, 256, True, 2048)
# the MoE configs' prefills of phase 25: deepseek-moe-16b (MHA, G = 1)
# and qwen3-moe-235b-a22b (GQA of 16)
DEEPSEEK_ATTN = (4, 2048, 2048, 16, 16, 128, True, None)
QWEN3_MOE_ATTN = (4, 2048, 2048, 64, 4, 128, True, None)
TIMED_ATTN = [QWEN_ATTN, QWEN3_ATTN, DANUBE_ATTN, RG_ATTN, DEEPSEEK_ATTN,
              QWEN3_MOE_ATTN]
FA_CHECKS = [QWEN_ATTN, (2, 333, 333, 14, 2, 64, True, 128),
             (2, 512, 512, 4, 4, 128, True, None),
             (2, 300, 700, 8, 2, 64, False, None),
             (1, 90, 40, 2, 1, 128, False, 16)] + [
    (B, 256, 256, 14, 2, 64, True, None) for B in LM_TRAIN_ROWS] + [
    QWEN3_ATTN, DANUBE_ATTN, RG_ATTN, (2, 300, 700, 8, 2, 120, False, None),
    (1, 333, 333, 4, 1, 256, True, 100), DEEPSEEK_ATTN, QWEN3_MOE_ATTN]
# (B, S, H, hd, N, chunk, decay): the mamba2-780m prefill first
MAMBA_SSD = (4, 2048, 48, 64, 128, 256)
SSD_CHECKS = [MAMBA_SSD + ("strong",), MAMBA_SSD + ("mild",),
              (2, 1000, 48, 64, 128, 256, "mild"),
              (2, 1024, 48, 64, 128, 128, "mild")] + [
    # LM training: S = chunk = 256, one chunk
    (B, 256, 48, 64, 128, 256, decay) for B in LM_TRAIN_ROWS
    for decay in ("strong", "mild")]
# The reduced mamba2-780m config's SSD sizes (chunk 32, hd 32, N 16; its
# H 16), with a ragged S; and its LM serving: batch, prompt, tokens
REDUCED_SSD = (2, 200, 16, 32, 16, 32)
REDUCED_LM = (4, 200, 8)
# The executor at full width: PAPER_MLP cut to 4 epochs in 4 chapters
# (one mini-epoch each: 4 x 4 x 64 = 1024 grad steps at M = 128) on the
# phase-11 task, on 4 nodes (4 CUDA streams of one card)
EXEC_EPOCHS = EXEC_SPLITS = 4
EXEC_NODES = 4
# the kill-then-resume pair through the executor's CLI
EXEC_CLI = ["-m", "repro_torch.core.pff_exec", "--device", "cuda",
            "--schedule", "all_layers", "--nodes", "4", "--splits", "4",
            "--n-train", "1000"]
# the trace gate's slack (obs.analyze's selftest): the card runs the four
# streams as one host thread feeds them, so the makespan sits near serial
TRACE_SLACK = 1.5
ROOT = os.path.dirname(os.path.abspath(__file__))
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
# LM families (phase 23): prompt length and attention kernel calls per
# prefill at full depth; the f32 gate's generated tokens
LM_FAMILIES = {"tinyllama-1.1b": (2048, 22), "qwen3-8b": (2048, 36),
               "h2o-danube-3-4b": (4608, 24), "recurrentgemma-2b": (4096, 8)}
LM_F32_GEN = 8
# phase 24: the reduced configs whose windows (64, 32) wrap at REDUCED_LM
REDUCED_FAMILIES = ("h2o-danube-3-4b", "recurrentgemma-2b")
# The MoE configs (phase 25): blocks served (deepseek-moe-16b whole;
# qwen3-moe-235b-a22b at its published widths cut to 10 of its 94
# blocks, ~52 GB in bf16: the whole model, ~470 GB, does not fit one
# card) and attention kernel calls per prefill; prompts of LM_PROMPT
MOE_LM = {"deepseek-moe-16b": (28, 28), "qwen3-moe-235b-a22b": (10, 10)}
# phase 26: the reduced MoE configs at REDUCED_LM (T = 800, the sorted
# branch) and at a short prompt (B 4 x 32: T = 128 = 64 top_k, the
# dense-local branch)
REDUCED_MOE_SHORT = 32
# Train-while-serve (phase 19): the phase-17 cell served meanwhile at the
# phase-6 traffic (uniform, 2000 req/s, batches of 64), final_probe
# requests at the final weights
TWS_RATE, TWS_PROBE = 2000.0, 128
# LM chapter training (phases 21-22): batch, sequence and steps per
# chapter; qwen2-0.5b runs 2 chapters (sequential, the executor's
# all_layers and single_layer on 4 streams, the plain route), mamba2-780m
# 1 (sequential, plain route)
LM_TRAIN_BATCH, LM_SEQ, LM_STEPS = 4, 256, 2
LM_CHAPTERS = {"qwen2-0.5b": 2, "mamba2-780m": 1}
# eval CE (mean over 16 x 256 val positions) of the kernel-routed fit
# against the plain-routed fit: two different trained models (the bf16
# forwards differ by ~1 bf16 step per element, phase 15, and training
# inherits that through the frozen prefixes), held to 5e-2 absolute
LM_CE_TOL = 5e-2
# The kernels' gate on this path: the sequential fit's params scored both
# ways, |eval CE through the kernels - through the plain route|. The
# limit sits between that reading and a control: the plain route's CE of
# the same params with the last block's mixer dropped (its output
# projection, attention wo or SSD out_proj, zeroed), as if one kernel
# call had returned zeros. A second control, every mixer output scaled
# by 1 + 2^-6, is printed, not gated: the mamba2 stack is nearly
# invariant to it (its RMSNorms absorb the scale). PERF.md gives the
# readings.
LM_SAME_CE_TOL = 1e-3
LM_CE_SCALE = 1 + 2.0 ** -6


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_summary(log):
    """One line per kernel of the build log: its source, registers,
    static shared memory and spills as ``ptxas -v`` reported them, the
    name demangled by ``c++filt`` where the machine has it."""
    rows, src, name, spills = [], None, None, None
    for line in log.splitlines():
        if line.startswith("/") and " -c " in line:
            src = os.path.basename(line.split(" -c ")[1].split()[0])
        elif "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "bytes spill stores" in line:
            spills = line.strip()
        elif line.startswith("ptxas info    : Used"):
            rows.append((src, name, line.split(": ", 1)[1], spills))
    names = [r[1] for r in rows]
    return [f"{src} {nm}: {used}; {spills}"
            for (src, _, used, spills), nm in zip(rows,
                                                  demangle(names) or names)]


def demangle(names):
    """``c++filt`` of each name, without the anonymous namespace and the
    parameter list; None where the machine has no ``c++filt``."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        return None
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in out[:len(names)]]


def sass_mma_counts(lib, sources):
    """{kernel: tensor-core instructions in its SASS} for the kernels of
    ``sources`` (file names, matched in the mangled names), from
    ``cuobjdump -sass`` of the built library; None where the toolkit has
    no cuobjdump."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    counts, name = {}, None
    tags = [src.replace(".", "_") for src in sources]
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if any(t in name for t in tags) else None
            if name:
                counts[name] = 0
        elif name and "HMMA" in line:
            counts[name] += 1
    return dict(zip(demangle(list(counts)) or list(counts),
                    counts.values()))


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


def fwd_work(M, K, N, norm):
    """(product operations, elementwise operations, bytes) of ff_dense in
    f32: 2*M*K*N for x @ w, the epilogue's bias, relu, square and sum
    (and the divide with norm), each input read once and each output
    written once."""
    return (2 * M * K * N, 4 * M * N + (M * N if norm else 0),
            4 * (M * K + K * N + N) + 4 * (M * N + M))


def bound(M, K, N, norm):
    """(ms, what bounds it) for ff_dense in f32 on the kernel's route: the
    larger of the operations (the product as 3xTF32, three TF32 products
    for each f32 one, at the TF32 tensor-core rate; the epilogue at the
    f32 rate) and the bytes over the memory rate."""
    mm, elementwise, nbytes = fwd_work(M, K, N, norm)
    return roofline(elementwise, nbytes, tf32_flops=3 * mm)


def fma_ms(M, K, N, norm):
    """The same function's bound with the product at the f32 FMA rate, the
    route before the tensor cores: printed beside the bound."""
    mm, elementwise, nbytes = fwd_work(M, K, N, norm)
    return roofline(mm + elementwise, nbytes)[0]


def tile_times(kernel, x, w, b, flush):
    """The whole call (norm off) at each block width gemm_split is built
    for, and which one ``_fwd_tile`` picks, as a printable string."""
    M, N = x.shape[0], w.shape[1]
    times = {bn: time_ms(lambda: kernel._launch(x, w, b, False, bn=bn), flush)
             for bn in kernel.FWD_BNS}
    K = x.shape[1]
    return (", ".join(f"{bn} columns {ms:.4f} ms "
                      f"({kernel._fwd_split(M, K, N, bn)[0]} slices of K)"
                      for bn, ms in times.items())
            + f"; the wrapper picks {kernel._fwd_tile(M, N)}")


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


def fa_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the function reads for one head: row i sees
    keys j < Sk with j <= i when causal and i - j < window when a window
    is given; a row that sees none averages v over all Sk keys."""
    i = np.arange(Sq)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0 * i
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    seen = np.maximum(hi - lo + 1, 0)
    return int(np.where(seen > 0, seen, Sk).sum())


def fa_bound(B, Sq, Sk, H, KV, hd, causal, dtype, window=None):
    """(f32 operations, bytes, bf16 operations) for attention: the
    products over the visible pairs (``fa_pairs``: causal and window
    counted row by row), against q, k, v read once and out written
    once. In f32 both products
    count at the f32 FMA rate. In bf16 every product counts at the bf16
    tensor-core rate: Q.K^T on the bf16 inputs at every hd (the scale
    comes after the product), and P.V as two bf16 products, P split into
    bf16(p) and bf16(p - bf16(p)) to keep the reference's f32 P; counting
    P.V at the f32 rate would bound the function by a path the kernel
    does not take."""
    pairs = B * H * fa_pairs(Sq, Sk, causal, window)
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
    operations, against xbar, dA, b, c read once and y, hT written once.
    The kernel's route runs them on the tensor cores as 3xTF32:
    ``roofline(0, nbytes, tf32_flops=3 * ops)``; ``roofline(ops,
    nbytes)`` is the f32 FMA figure."""
    L = min(chunk, S)
    nc = -(-S // L)
    tri = L * (L + 1) / 2
    flops = (2 * B * nc * N * tri + 2 * B * H * nc * hd * tri
             + 4 * B * S * H * hd * N)
    nbytes = 4 * (2 * B * S * H * hd + B * S * H + 2 * B * S * N
                  + B * H * hd * N)
    return flops, nbytes


def roofline(flops, nbytes, bf16_flops=0, tf32_flops=0):
    """(ms, what bounds it): the larger of the operations (f32 ones over
    the f32 peak, bf16 ones over the bf16 tensor-core peak and TF32 ones
    over the TF32 tensor-core peak, summed) and the bytes over the memory
    rate."""
    t_ops = (flops / F32_PEAK_FLOPS + bf16_flops / BF16_PEAK_FLOPS
             + tf32_flops / TF32_PEAK_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_rows(gen, shape, fa_errs, flush):
    """14. The attention kernel at one prefill shape, bf16 and f32: its
    time, its plain version's, one SDPA call's (a causal and window mask
    passed as a boolean ``attn_mask`` where a window is given) and the
    bound. Returns the two kernels-line rows."""
    from repro_torch.kernels import flash_attention as fa

    B, Sq, Sk, H, KV, hd, causal, window = shape
    mask = None
    if window is not None:
        qpos = torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        mask = (qpos - kpos < window) & ((qpos >= kpos) if causal else True)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = fa_inputs(gen, B, Sq, Sk, H, KV, hd, dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        call = dict(causal=causal, window=window)
        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, **call), flush)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **call),
                           flush)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), flush)
        bound_ms, bound_by = roofline(*fa_bound(B, Sq, Sk, H, KV, hd, causal,
                                                dtype, window))
        rows.append({
            "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
            "replaces": FA_REPLACES, "shape": [B, Sq, Sk, H, KV, hd],
            "causal": causal, "window": window, "dtype": str(dtype)[6:],
            "launches": None, "max_abs_err": fa_errs[shape + (dtype,)],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(enable_gqa=True; "
                       "is_causal=True, or the causal and window mask as "
                       "attn_mask) on (B, H, S, hd) copies, TF32 off"})
        print(f"[14 time] flash_attention {shape} {str(dtype)[6:]}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{fa_pairs(Sq, Sk, causal, window)} pairs a head)")
        del q, k, v, qt, kt, vt
    return rows


def phase_reduced_ssd(gen, data):
    """16. The SSD kernel at the reduced mamba2-780m sizes against its
    plain version (ragged S), a repeat, its time, and ``lm_decode`` of
    the reduced config on the card with the kernel's calls counted.
    Returns the kernels-line row."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    B, S, H, hd, N, chunk = REDUCED_SSD
    xbar, dA, b, c = ssd_inputs(gen, B, S, H, hd, N, "mild")
    y, hT = ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk)
    again = ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk)
    torch.cuda.synchronize()
    yp, hp = ssd.mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk)
    check(y.shape == yp.shape and hT.shape == hp.shape
          and bool(torch.isfinite(y).all() and torch.isfinite(hT).all()),
          f"mamba2_ssd output shape/finite at {REDUCED_SSD}")
    ey, eh = scaled_err(y, yp), scaled_err(hT, hp)
    check(torch.equal(y, again[0]) and torch.equal(hT, again[1]),
          f"mamba2_ssd: two calls at {REDUCED_SSD} differ")
    print(f"[16 reduced ssd] mamba2_ssd {REDUCED_SSD} mild decay: y err "
          f"{ey:.3e}, hT err {eh:.3e} (<= {SSD_TOL}); repeat bit-identical")
    check(max(ey, eh) <= SSD_TOL, f"mamba2_ssd disagrees with its plain "
          f"version at {REDUCED_SSD}")
    max_abs = float(max((y - yp).abs().max(), (hT - hp).abs().max()))
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    kernel_ms = time_ms(lambda: ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk),
                        flush)
    plain_ms = time_ms(
        lambda: ssd.mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk), flush)
    ops, nbytes = ssd_bound(B, S, H, hd, N, chunk)
    bound_ms, bound_by = roofline(0, nbytes, tf32_flops=3 * ops)
    print(f"[16 reduced ssd] mamba2_ssd {REDUCED_SSD}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; 3xTF32)")
    del xbar, dA, b, c, y, hT, yp, hp, again, flush

    cfg = get_config("mamba2-780m").reduced()
    calls = sum(r * p.count("mamba2") for p, r in cfg.groups)
    batch, prompt, n_gen = REDUCED_LM
    params = transformer.init(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    counts.reset(fa, ssd)
    res = lm_decode(cfg, batch=batch, prompt_len=prompt, gen=n_gen, seed=0,
                    params=params)
    launches = ssd.LAUNCHES.total
    check(launches == calls and fa.LAUNCHES.total == 0,
          f"reduced mamba2 lm_decode made {launches} SSD kernel calls, "
          f"expected {calls}")
    res_ref = lm_decode(cfg, batch=batch, prompt_len=prompt, gen=n_gen,
                        seed=0, params=params, impl="ref")
    check(ssd.LAUNCHES.total == launches,
          "impl='ref' launched the SSD kernel")
    gk = res["generated"]
    check(gk.shape == (batch, n_gen) and bool(
        ((gk >= 0) & (gk < cfg.vocab)).all()),
          "reduced mamba2: generated tokens of the wrong shape or range")
    prompts = torch.as_tensor(next(iter(data.lm_batches(
        cfg.vocab, batch, prompt - 1, 1, 0))), device="cuda")
    lk, lr = lm_gate("reduced mamba2", cfg, params, prompts, prompt + n_gen,
                     calls, "[16 reduced lm]", "mamba2_ssd")
    e = scaled_err(lk, lr)
    decided = top2_margin(lr) > F32_MARGIN
    same = gk[:, 0] == res_ref["generated"][:, 0]
    print(f"[16 reduced lm] {cfg.name} (B {batch}, prompt {prompt}, gen "
          f"{n_gen}, {cfg.dtype}): {launches} mamba2_ssd calls in prefill; "
          f"last-position prefill logits kernel vs plain err {e:.3e} "
          f"(<= {PATH_TOL}); first token equal on "
          f"{int(same[decided].sum())}/{int(decided.sum())} decided rows; "
          f"prefill s kernel / plain {res['prefill_s']:.4f} / "
          f"{res_ref['prefill_s']:.4f}")
    check(bool(torch.isfinite(lk).all()) and e <= PATH_TOL,
          f"reduced mamba2: prefill logits, kernel vs plain, {e}")
    check(bool(same[decided].all()), "reduced mamba2: first generated "
          "tokens differ from the plain path on decided rows")
    return {
        "name": "mamba2_ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "shape": list(REDUCED_SSD),
        "dtype": "float32", "launches": launches, "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "path": "lm_decode of the reduced mamba2-780m config"}


def attention_calls(cfg):
    """Attention kernel calls a prefill of ``cfg`` makes: one per ``attn``
    or ``local_attn`` block."""
    return sum(r * sum(k in ("attn", "local_attn") for k in p)
               for p, r in cfg.groups)


def cut_depth(cfg):
    """``cfg`` in f32 with one unit of each group pattern (the f32 gate's
    depth): widths unchanged."""
    groups = tuple((p, 1) for p, _ in cfg.groups)
    return dataclasses.replace(cfg, dtype="float32", groups=groups,
                               num_layers=sum(len(p) for p, _ in groups))


def lm_gate(name, cfg, params, prompts, max_len, calls, tag,
            op="flash_attention"):
    """Prefill ``prompts`` through the kernels (``calls`` launches of
    ``op``'s kernel and none of the other, counts zeroed first) and the
    plain route, with three decode steps between them that must launch
    nothing. Returns the last-position logits over the real vocab,
    kernel and plain."""
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models import transformer

    counter, other = (fa, ssd) if op == "flash_attention" else (ssd, fa)
    S = prompts.shape[1]
    with torch.no_grad():
        counts.reset(fa, ssd)
        lk, caches = transformer.prefill(params, cfg, prompts,
                                         max_len=max_len, last_only=True)
        check(counter.LAUNCHES.total == calls and other.LAUNCHES.total == 0,
              f"{tag} {name}: prefill made {counter.LAUNCHES.total} {op} "
              f"kernel calls, expected {calls}")
        tok = lk.argmax(-1)
        for i in range(3):
            _, caches = transformer.serve_step(params, cfg, caches, tok,
                                               S + i)
        torch.cuda.synchronize()
        check(counter.LAUNCHES.total == calls and other.LAUNCHES.total == 0,
              f"{tag} {name}: decode launched a kernel")
        del caches
        lr, _ = transformer.prefill(params, cfg, prompts, max_len=max_len,
                                    last_only=True, impl="ref")
    check(counter.LAUNCHES.total == calls and other.LAUNCHES.total == 0,
          f"{tag} {name}: impl='ref' launched a kernel")
    return lk[:, :cfg.vocab], lr[:, :cfg.vocab]


def phase_lm_families(data):
    """23. The dense and hybrid configs served at published widths and
    depth in bf16 (the main path: counts zeroed just before the kernel
    route's ``lm_decode`` and read just after), then gated in f32 at
    ``cut_depth``. Returns the main paths' attention kernel calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    total = 0
    for name, (prompt, calls) in LM_FAMILIES.items():
        cfg = get_config(name)
        check(attention_calls(cfg) == calls, f"{name}: the config has "
              f"{attention_calls(cfg)} attention blocks, expected {calls}")
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        n_params = transformer.param_count(params)

        def run(impl, gen=LM_GEN, cfg=cfg, params=params):
            return lm_decode(cfg, batch=LM_BATCH, prompt_len=prompt, gen=gen,
                             seed=0, params=params, impl=impl)

        for impl in ("auto", "ref"):
            run(impl, gen=2)
        counts.reset(fa, ssd)
        res = run("auto")
        launches = fa.LAUNCHES.total
        check(launches == calls and ssd.LAUNCHES.total == 0,
              f"{name}: lm_decode made {launches} attention kernel calls "
              f"(and {ssd.LAUNCHES.total} SSD), expected {calls} and 0")
        total += launches
        res_ref = run("ref")
        check(fa.LAUNCHES.total == calls, f"{name}: impl='ref' launched the "
              f"attention kernel")
        gk, gr = res["generated"], res_ref["generated"]
        check(gk.shape == (LM_BATCH, LM_GEN) and bool(
            ((gk >= 0) & (gk < cfg.vocab)).all()),
              f"{name}: generated tokens of the wrong shape or range")
        prompts = torch.as_tensor(next(iter(data.lm_batches(
            cfg.vocab, LM_BATCH, prompt - 1, 1, 0))), device="cuda")
        lk, lr = lm_gate(name, cfg, params, prompts, prompt + LM_GEN, calls,
                         "[23 lm-families]")
        check(bool(torch.isfinite(lk).all()), f"{name}: non-finite logits")
        e = scaled_err(lk, lr)
        # rows whose first token the measured logit difference cannot flip
        decided = top2_margin(lr) > 2 * float((lk - lr).abs().max())
        same = gk[:, 0] == gr[:, 0]
        agree = float((gk == gr).float().mean())
        print(f"[23 lm-families] {name} bf16 ({n_params / 1e9:.3f} B "
              f"params; B {LM_BATCH}, prompt {prompt}, gen {LM_GEN}): "
              f"{launches} flash_attention calls in prefill, 0 in decode; "
              f"last-position prefill logits kernel vs plain err {e:.3e} "
              f"(<= {LM_BF16_TOL}); first token equal on "
              f"{int(same[decided].sum())}/{int(decided.sum())} rows whose "
              f"plain top-2 margin exceeds twice the largest logit "
              f"difference ({int(same.sum())}/{LM_BATCH} in all); greedy "
              f"tokens agree {agree:.4f}; prefill s kernel / plain "
              f"{res['prefill_s']:.4f} / {res_ref['prefill_s']:.4f}; "
              f"decode tok/s {res['decode_tok_per_s']:.2f} / "
              f"{res_ref['decode_tok_per_s']:.2f}")
        print(json.dumps({"lm": name, "dtype": "bfloat16",
                          "batch": LM_BATCH, "prompt": prompt,
                          "gen": LM_GEN, "params": n_params,
                          "kernel": {k: res[k] for k in (
                              "prefill_s", "decode_s", "decode_tok_per_s")},
                          "plain": {k: res_ref[k] for k in (
                              "prefill_s", "decode_s", "decode_tok_per_s")},
                          "kernel_calls": launches, "logit_err": e,
                          "token_agreement": agree}))
        check(e <= LM_BF16_TOL, f"{name}: prefill logits, kernel path vs "
              f"plain path, {e} > {LM_BF16_TOL}")
        check(bool(same[decided].all()), f"{name} bf16: first generated "
              f"tokens differ from the plain path on decided rows")
        del params, res, res_ref, lk, lr, run
        torch.cuda.empty_cache()

        cfg32 = cut_depth(cfg)
        calls32 = attention_calls(cfg32)
        p32 = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg32)
        res = lm_decode(cfg32, batch=LM_BATCH, prompt_len=prompt,
                        gen=LM_F32_GEN, seed=0, params=p32)
        res_ref = lm_decode(cfg32, batch=LM_BATCH, prompt_len=prompt,
                            gen=LM_F32_GEN, seed=0, params=p32, impl="ref")
        lk, lr = lm_gate(name, cfg32, p32, prompts, prompt + LM_F32_GEN,
                         calls32, "[23 lm-families] f32")
        e = scaled_err(lk, lr)
        decided = top2_margin(lr) > F32_MARGIN
        same = res["generated"][:, 0] == res_ref["generated"][:, 0]
        print(f"[23 lm-families] {name} f32 at one unit of each group "
              f"({cfg32.num_layers} blocks, {calls32} attention calls): "
              f"last-position prefill logits kernel vs plain err {e:.3e} "
              f"(<= {PATH_TOL}); first token equal on "
              f"{int(same[decided].sum())}/{int(decided.sum())} rows with "
              f"top-2 margin > {F32_MARGIN}; prefill s kernel / plain "
              f"{res['prefill_s']:.4f} / {res_ref['prefill_s']:.4f}")
        check(e <= PATH_TOL, f"{name} f32: prefill logits, kernel path vs "
              f"plain path, {e} > {PATH_TOL}")
        check(bool(same[decided].all()), f"{name} f32: first generated "
              f"tokens differ from the plain path on decided rows")
        del p32, res, res_ref, lk, lr, prompts
        torch.cuda.empty_cache()
    return total


def phase_reduced_families(data):
    """24. The reduced h2o-danube-3-4b and recurrentgemma-2b (f32, hd 64)
    served on the card at ``REDUCED_LM``, prompts past their windows:
    attention kernel calls of the main path (counts zeroed just before),
    prefill logits and first tokens against the plain path. Returns the
    calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    batch, prompt, n_gen = REDUCED_LM
    total = 0
    for name in REDUCED_FAMILIES:
        cfg = get_config(name).reduced()
        calls = attention_calls(cfg)
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        counts.reset(fa, ssd)
        res = lm_decode(cfg, batch=batch, prompt_len=prompt, gen=n_gen,
                        seed=0, params=params)
        launches = fa.LAUNCHES.total
        check(launches == calls and ssd.LAUNCHES.total == 0,
              f"reduced {name}: lm_decode made {launches} attention kernel "
              f"calls, expected {calls}")
        total += launches
        res_ref = lm_decode(cfg, batch=batch, prompt_len=prompt, gen=n_gen,
                            seed=0, params=params, impl="ref")
        gk = res["generated"]
        check(gk.shape == (batch, n_gen) and bool(
            ((gk >= 0) & (gk < cfg.vocab)).all()),
              f"reduced {name}: generated tokens of the wrong shape or range")
        prompts = torch.as_tensor(next(iter(data.lm_batches(
            cfg.vocab, batch, prompt - 1, 1, 0))), device="cuda")
        lk, lr = lm_gate(name, cfg, params, prompts, prompt + n_gen, calls,
                         "[24 reduced families]")
        e = scaled_err(lk, lr)
        decided = top2_margin(lr) > F32_MARGIN
        same = gk[:, 0] == res_ref["generated"][:, 0]
        window = (cfg.rglru.window if cfg.rglru else cfg.window)
        print(f"[24 reduced families] {cfg.name} (B {batch}, prompt "
              f"{prompt}, gen {n_gen}, window {window}, {cfg.dtype}): "
              f"{launches} flash_attention calls in prefill; last-position "
              f"prefill logits kernel vs plain err {e:.3e} (<= {PATH_TOL}); "
              f"first token equal on {int(same[decided].sum())}/"
              f"{int(decided.sum())} decided rows; greedy tokens agree "
              f"{float((gk == res_ref['generated']).float().mean()):.4f}")
        check(bool(torch.isfinite(lk).all()) and e <= PATH_TOL,
              f"reduced {name}: prefill logits, kernel vs plain, {e}")
        check(bool(same[decided].all()), f"reduced {name}: first generated "
              f"tokens differ from the plain path on decided rows")
    return total


def moe_prefill_work(cfg, B, S):
    """(f32 operations, bf16 operations) of one prefill of B prompts of S
    tokens at the code's shapes: per block the expert GEMMs over every
    capacity slot (E·C in the sorted branch, which computes empty slots
    too; E·T in the dense-local one), the shared MLP, the q/k/v/o
    projections and the two attention products over the causal pairs,
    then the last position's head, all bf16; the router's product in f32
    (TF32 off)."""
    from repro_torch.models import mlp

    T, d, m = B * S, cfg.d_model, cfg.moe
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv
    slots = m.num_experts * (
        T if T <= 64 * m.top_k
        else mlp._capacity(T, m.top_k, m.num_experts, m.capacity_factor))
    block = (slots * 6 * d * m.expert_ff
             + T * 6 * d * m.num_shared * m.shared_ff
             + T * 2 * d * hd * (2 * H + 2 * KV)
             + B * H * fa_pairs(S, S, True, None) * hd * 4)
    n = cfg.num_layers
    return n * T * 2 * d * m.num_experts, n * block + B * 2 * d * cfg.vocab


def decode_step_bytes(cfg, params, B, pos):
    """Bytes one decode step must read: every weight but the embedding
    table (the dense-local branch runs every expert), B embedding rows,
    and the KV caches up to ``pos``."""
    from repro_torch.convert import tree_leaves

    w = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    emb = params["embed"]
    kv = (2 * cfg.num_layers * B * pos * cfg.n_kv * cfg.resolved_head_dim
          * emb.element_size())
    return w - emb.numel() * emb.element_size() + B * emb[0].nbytes + kv


@contextlib.contextmanager
def routing(T, replay=None):
    """Records the expert ids of every router call over ``T`` tokens (a
    prefill's; a decode step's have T = B) while the span lasts: a list
    of (T, k) tensors on the card, in block order. With ``replay`` (such
    a list), those calls take its ids instead, their gates the router's
    probabilities at those ids renormalised as ``_router`` does: the
    discrete routing of another run, pinned."""
    from repro_torch.models import mlp

    calls, router = [], mlp._router
    pinned = iter(replay) if replay is not None else None

    def recording(p, x, moe):
        gate, eids, aux = router(p, x, moe)
        if x.shape[0] == T:
            if pinned is not None:
                eids = next(pinned)
                with mlp.full_f32():
                    probs = torch.softmax(x.float() @ p["router"], dim=-1)
                gate = probs.gather(1, eids)
                gate = gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9)
            calls.append(eids.clone())
        return gate, eids, aux

    mlp._router = recording
    try:
        yield calls
    finally:
        mlp._router = router


def routing_agreement(a, b):
    """Two prefills' routings (``routing`` lists): the share of (token,
    slot) choices equal, and the share of each token's k experts that
    the other run chose too (order within the top-k aside), each per
    block."""
    slots = [float((x == y).float().mean()) for x, y in zip(a, b)]
    sets = [float((x[:, :, None] == y[:, None, :]).any(-1).float().mean())
            for x, y in zip(a, b)]
    return slots, sets


def dropped(cfg, calls, T):
    """(capacity, the (token, slot) pairs past it, summed over the
    blocks) of a prefill's routing; no capacity in the dense-local
    branch."""
    from repro_torch.models import mlp

    m = cfg.moe
    if T <= 64 * m.top_k:
        return None, 0
    cap = mlp._capacity(T, m.top_k, m.num_experts, m.capacity_factor)
    return cap, sum(int((torch.bincount(e.reshape(-1), minlength=m.num_experts)
                         - cap).clamp(min=0).sum()) for e in calls)


def nudged_attention(q, k, v, *, causal, window):
    """The plain attention with one in ten output elements moved one
    bf16 (or f32) step away from zero, at places drawn from a fixed
    seed: a control as far from the plain version as the kernel may be
    (phase 12's elementwise limit), run on the plain route."""
    from repro_torch.kernels import ref

    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    gen = torch.Generator(device=o.device).manual_seed(1)
    bits = torch.int16 if o.dtype == torch.bfloat16 else torch.int32
    step = torch.rand(o.shape, generator=gen, device=o.device) < 0.1
    return (o.view(bits) + step.to(bits)).view(o.dtype)


def moe_gate(name, cfg, params, prompts, max_len, calls, tag, tol):
    """The MoE's prefill gate. Prefills ``prompts`` through the plain
    route (its routing recorded), through the kernels (``calls``
    launches, counts zeroed first; three decode steps after it launch
    nothing), through the kernels with the plain route's routing pinned,
    and through the plain route with its attention nudged
    (``nudged_attention``). A top-k choice is a discontinuity: one
    flipped choice moves a token's output by a whole expert's share, and
    later blocks carry it on. So the kernels are gated with the routing
    pinned: last-position logits over the real vocab within ``tol``,
    first tokens equal where the plain top-2 margin exceeds twice the
    largest logit difference. The free-running kernel route is printed
    beside the nudged control, whose distance from the plain route is
    the model's own sensitivity to a one-step change of attention.
    Returns the readings."""
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models import transformer

    B, S = prompts.shape
    T = B * S

    def prefill(impl="auto"):
        return transformer.prefill(params, cfg, prompts, max_len=max_len,
                                   last_only=True, impl=impl)

    with torch.no_grad():
        with routing(T) as plain_route:
            lr, _ = prefill("ref")
        counts.reset(fa, ssd)
        with routing(T) as kernel_route:
            lk, caches = prefill()
        check(fa.LAUNCHES.total == calls and ssd.LAUNCHES.total == 0,
              f"{tag} {name}: prefill made {fa.LAUNCHES.total} attention "
              f"kernel calls (and {ssd.LAUNCHES.total} SSD), expected "
              f"{calls} and 0")
        tok = lk.argmax(-1)
        for i in range(3):
            _, caches = transformer.serve_step(params, cfg, caches, tok,
                                               S + i)
        torch.cuda.synchronize()
        check(fa.LAUNCHES.total == calls, f"{tag} {name}: decode launched "
              f"a kernel")
        del caches
        with routing(T, replay=plain_route):
            lp, _ = prefill()
        check(fa.LAUNCHES.total == 2 * calls and ssd.LAUNCHES.total == 0,
              f"{tag} {name}: the pinned prefill made "
              f"{fa.LAUNCHES.total - calls} attention kernel calls")
        with routing(T) as nudged_route:
            ln, _ = prefill("nudged")
        check(fa.LAUNCHES.total == 2 * calls, f"{tag} {name}: the plain "
              f"routes launched a kernel")
    V = cfg.vocab
    lr, lk, lp, ln = lr[:, :V], lk[:, :V], lp[:, :V], ln[:, :V]
    check(all(bool(torch.isfinite(t).all()) for t in (lr, lk, lp, ln)),
          f"{tag} {name}: non-finite logits")
    e_pin = scaled_err(lp, lr)
    decided = top2_margin(lr) > 2 * float((lp - lr).abs().max())
    same = lp.argmax(-1) == lr.argmax(-1)
    slots, sets = routing_agreement(kernel_route, plain_route)
    _, nsets = routing_agreement(nudged_route, plain_route)
    cap, drop_r = dropped(cfg, plain_route, T)
    out = {"logit_err_pinned": e_pin, "logit_err_free": scaled_err(lk, lr),
           "logit_err_nudged_control": scaled_err(ln, lr),
           "routing_slots_equal": float(np.mean(slots)),
           "routing_experts_equal": float(np.mean(sets)),
           "routing_experts_equal_by_block": sets,
           "routing_experts_equal_nudged_control": float(np.mean(nsets)),
           "capacity": cap, "dropped": {
               "plain": drop_r, "kernel": dropped(cfg, kernel_route, T)[1],
               "nudged_control": dropped(cfg, nudged_route, T)[1]},
           "pairs": T * cfg.moe.top_k * cfg.num_layers,
           "first_token_decided": [int(same[decided].sum()),
                                   int(decided.sum())]}
    print(f"{tag} {name} {cfg.dtype} (T {T}, capacity {cap}): routing "
          f"pinned to the plain route's: last-position prefill logits "
          f"kernel vs plain err {e_pin:.3e} (<= {tol}); first token equal "
          f"on {int(same[decided].sum())}/{int(decided.sum())} rows whose "
          f"plain top-2 margin exceeds twice the largest logit difference "
          f"({int(same.sum())}/{B} in all)")
    print(f"{tag} {name} {cfg.dtype} free-running: logits err "
          f"{out['logit_err_free']:.3e} (the nudged plain control "
          f"{out['logit_err_nudged_control']:.3e}); (token, slot) choices "
          f"equal {out['routing_slots_equal']:.6f}, experts equal "
          f"{out['routing_experts_equal']:.6f} (control "
          f"{out['routing_experts_equal_nudged_control']:.6f}; by block "
          f"{[round(x, 4) for x in sets]}); pairs dropped plain / kernel / "
          f"control {drop_r} / {out['dropped']['kernel']} / "
          f"{out['dropped']['nudged_control']} of {out['pairs']}")
    check(e_pin <= tol, f"{tag} {name}: prefill logits with the routing "
          f"pinned, kernel path vs plain path, {e_pin} > {tol}")
    check(bool(same[decided].all()), f"{tag} {name}: first tokens differ "
          f"from the plain path's on decided rows")
    return out


def moe_cut(cfg, blocks):
    """``cfg`` with its one group cut to ``blocks`` blocks; widths as
    published."""
    (pattern, _), = cfg.groups
    return dataclasses.replace(cfg, num_layers=blocks * len(pattern),
                               groups=((pattern, blocks),))


def phase_moe_lm(data):
    """25. The MoE configs served in bf16 at published widths (the main
    path: counts zeroed just before the kernel route's ``lm_decode`` and
    read just after), deepseek-moe-16b at its depth and
    qwen3-moe-235b-a22b cut to 10 blocks, with ``moe_gate``; then in f32
    at one block. Returns the main paths' attention kernel calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    total = 0
    for name, (depth, calls) in MOE_LM.items():
        cfg = moe_cut(get_config(name), depth)
        check(attention_calls(cfg) == calls, f"{name}: {depth} blocks hold "
              f"{attention_calls(cfg)} attention blocks, expected {calls}")
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        n_params = transformer.param_count(params)

        def run(impl, gen=LM_GEN, cfg=cfg, params=params):
            return lm_decode(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                             gen=gen, seed=0, params=params, impl=impl)

        for impl in ("auto", "ref"):
            run(impl, gen=2)
        counts.reset(fa, ssd)
        res = run("auto")
        launches = fa.LAUNCHES.total
        check(launches == calls and ssd.LAUNCHES.total == 0,
              f"{name}: lm_decode made {launches} attention kernel calls "
              f"(and {ssd.LAUNCHES.total} SSD), expected {calls} and 0")
        total += launches
        res_ref = run("ref")
        check(fa.LAUNCHES.total == calls, f"{name}: impl='ref' launched the "
              f"attention kernel")
        gk, gr = res["generated"], res_ref["generated"]
        check(gk.shape == (LM_BATCH, LM_GEN) and bool(
            ((gk >= 0) & (gk < cfg.vocab)).all()),
              f"{name}: generated tokens of the wrong shape or range")
        prompts = torch.as_tensor(next(iter(data.lm_batches(
            cfg.vocab, LM_BATCH, LM_PROMPT - 1, 1, 0))), device="cuda")
        gate = moe_gate(name, cfg, params, prompts, LM_PROMPT + LM_GEN,
                        calls, "[25 moe]", LM_BF16_TOL)
        f32_ops, bf16_ops = moe_prefill_work(cfg, LM_BATCH, LM_PROMPT)
        pre_bound, _ = roofline(f32_ops, decode_step_bytes(cfg, params, 0, 0),
                                bf16_ops)
        step_bytes = decode_step_bytes(cfg, params, LM_BATCH,
                                       LM_PROMPT + LM_GEN // 2)
        step_bound, step_by = roofline(0, step_bytes)
        step_ms = [1e3 * r["decode_s"] / (LM_GEN - 1) for r in (res, res_ref)]
        agree = float((gk == gr).float().mean())
        print(f"[25 moe] {name} bf16 ({cfg.num_layers} blocks, "
              f"{n_params / 1e9:.3f} B params; B {LM_BATCH}, prompt "
              f"{LM_PROMPT}, gen {LM_GEN}): {launches} flash_attention calls "
              f"in prefill, 0 in decode; greedy tokens of the two routes "
              f"agree {agree:.4f}; prefill s kernel / plain "
              f"{res['prefill_s']:.4f} / {res_ref['prefill_s']:.4f} (bound "
              f"{pre_bound:.2f} ms: {bf16_ops / 1e12:.2f} TFLOP bf16 + "
              f"{f32_ops / 1e12:.3f} f32); decode step ms kernel / plain "
              f"{step_ms[0]:.3f} / {step_ms[1]:.3f}, tok/s "
              f"{res['decode_tok_per_s']:.2f} / "
              f"{res_ref['decode_tok_per_s']:.2f} (bound {step_bound:.3f} ms "
              f"a step, {step_by}: {step_bytes / 1e9:.2f} GB)")
        print(json.dumps({"lm": name, "dtype": "bfloat16",
                          "blocks": cfg.num_layers, "batch": LM_BATCH,
                          "prompt": LM_PROMPT, "gen": LM_GEN,
                          "params": n_params,
                          "kernel": {k: res[k] for k in (
                              "prefill_s", "decode_s", "decode_tok_per_s")},
                          "plain": {k: res_ref[k] for k in (
                              "prefill_s", "decode_s", "decode_tok_per_s")},
                          "prefill_bound_ms": pre_bound,
                          "decode_step_bound_ms": step_bound,
                          "kernel_calls": launches, "token_agreement": agree,
                          **gate}))
        del params, res, res_ref, run
        torch.cuda.empty_cache()

        cfg32 = cut_depth(cfg)
        calls32 = attention_calls(cfg32)
        p32 = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg32)
        res = lm_decode(cfg32, batch=LM_BATCH, prompt_len=LM_PROMPT,
                        gen=LM_F32_GEN, seed=0, params=p32)
        res_ref = lm_decode(cfg32, batch=LM_BATCH, prompt_len=LM_PROMPT,
                            gen=LM_F32_GEN, seed=0, params=p32, impl="ref")
        gate = moe_gate(name, cfg32, p32, prompts, LM_PROMPT + LM_F32_GEN,
                        calls32, "[25 moe] f32 one block", PATH_TOL)
        print(f"[25 moe] {name} f32 at one block: greedy tokens of the two "
              f"routes agree "
              f"{float((res['generated'] == res_ref['generated']).float().mean()):.4f}"
              f"; prefill s kernel / plain {res['prefill_s']:.4f} / "
              f"{res_ref['prefill_s']:.4f}")
        del p32, res, res_ref, prompts
        torch.cuda.empty_cache()
    return total


def phase_reduced_moe(data):
    """26. The reduced deepseek-moe-16b and qwen3-moe-235b-a22b (f32, d
    256, 4 experts top-2, one block) served on the card at
    ``REDUCED_LM`` (T = 800: the sorted branch) and at a short prompt
    (T = 128: the dense-local branch): attention kernel calls of the main
    path (counts zeroed just before), then ``moe_gate`` at
    ``PATH_TOL``. Returns the calls."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import counts, flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.launch.serve import lm_decode
    from repro_torch.models import transformer

    batch, long_prompt, n_gen = REDUCED_LM
    total = 0
    for name in MOE_LM:
        cfg = get_config(name).reduced()
        calls = attention_calls(cfg)
        params = transformer.init(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        for prompt in (long_prompt, REDUCED_MOE_SHORT):
            T = batch * prompt
            counts.reset(fa, ssd)
            res = lm_decode(cfg, batch=batch, prompt_len=prompt, gen=n_gen,
                            seed=0, params=params)
            launches = fa.LAUNCHES.total
            check(launches == calls and ssd.LAUNCHES.total == 0,
                  f"reduced {name}: lm_decode made {launches} attention "
                  f"kernel calls, expected {calls}")
            total += launches
            res_ref = lm_decode(cfg, batch=batch, prompt_len=prompt,
                                gen=n_gen, seed=0, params=params, impl="ref")
            gk = res["generated"]
            check(gk.shape == (batch, n_gen) and bool(
                ((gk >= 0) & (gk < cfg.vocab)).all()),
                  f"reduced {name}: generated tokens of the wrong shape or "
                  f"range")
            prompts = torch.as_tensor(next(iter(data.lm_batches(
                cfg.vocab, batch, prompt - 1, 1, 0))), device="cuda")
            branch = "dense-local" if T <= 64 * cfg.moe.top_k else "sorted"
            moe_gate(name, cfg, params, prompts, prompt + n_gen, calls,
                     f"[26 reduced moe, {branch} branch]", PATH_TOL)
            print(f"[26 reduced moe] {cfg.name} (B {batch}, prompt {prompt}, "
                  f"gen {n_gen}): {launches} flash_attention call in "
                  f"prefill; greedy tokens of the two routes agree "
                  f"{float((gk == res_ref['generated']).float().mean()):.4f}")
    return total


def phase_executor(api, data, base_cfg, kernel, vjp):
    """17. The PFF executor at full width, on 4 CUDA streams of the card,
    against the sequential and federated trainers bit for bit; 18. its
    resilience. Returns the executor's main run's (ff_dense,
    ff_dense_bwd) calls and its all_layers ``FitResult``. Runs under
    torch.use_deterministic_algorithms."""
    from repro_torch.core import faults, pff, pff_exec
    from repro_torch.kernels import counts
    from repro_torch.obs import analyze, trace as obs_trace

    cfg = dataclasses.replace(base_cfg, epochs=EXEC_EPOCHS,
                              splits=EXEC_SPLITS)
    task = data.mnist_like(seed=0, n_train=FIT_TRAIN, n_test=FIT_TEST)
    n_layers = len(cfg.layer_sizes) - 1
    grad_steps = (cfg.splits * n_layers * (cfg.epochs // cfg.splits)
                  * -(-FIT_TRAIN // cfg.batch_size))

    def counted(**kw):
        counts.reset(kernel, vjp)
        t0 = time.perf_counter()
        res = api.fit(cfg, task, **kw)
        wall = time.perf_counter() - t0
        return res, wall, (kernel.LAUNCHES.total, vjp.LAUNCHES.total)

    def same(a, b, what):
        check(pff_exec.params_bit_equal(a.params, b.params),
              f"{what}: params differ from the reference run's")
        check(a.test_acc == b.test_acc,
              f"{what}: test_acc {a.test_acc} != {b.test_acc}")

    seq, seq_s, seq_calls = counted(backend="sequential")
    check(seq_calls[1] == grad_steps and seq_calls[0] > 0,
          f"sequential fit: {seq_calls} kernel calls for {grad_steps} grad "
          f"steps")
    out = {"sequential": {"fit_s": seq_s, "calls": seq_calls,
                          "test_acc": seq.test_acc}}
    # the trainers score train accuracy on 2000 train rows after the fit
    # (one ff_dense call per layer a 2000-row chunk); the executor does
    # not. single_layer re-runs layers < k over the train set for both
    # acts (Algorithm 1) in place of the n_layers - 1 forwards between
    # train tasks
    train_acc_calls = -(-min(2000, FIT_TRAIN) // 2000) * n_layers
    recompute = cfg.splits * (sum(range(n_layers)) - (n_layers - 1)) * 2
    runs = (("all_layers", dict(schedule="all_layers"), 0),
            ("all_layers overlap off",
             dict(schedule="all_layers", overlap=False), 0),
            ("single_layer", dict(schedule="single_layer"), recompute))
    for label, kw, extra_fwd in runs:
        res, wall, calls = counted(backend="executor",
                                   num_nodes=EXEC_NODES, **kw)
        same(seq, res, f"executor {label}")
        check(calls == (seq_calls[0] - train_acc_calls + extra_fwd,
                        seq_calls[1]),
              f"executor {label}: kernel calls {calls}, sequential "
              f"{seq_calls} (-{train_acc_calls} train accuracy, "
              f"+{extra_fwd} forward recompute)")
        out[label] = {"fit_s": wall, "makespan_s": res.makespan,
                      "calls": calls, "handoff": res.raw.handoff}
        if label == "all_layers":
            exec_main = res
        print(f"[17 executor] {label} on {EXEC_NODES} streams: bit-identical "
              f"to the sequential fit; makespan {res.makespan:.4f} s (fit "
              f"{wall:.4f} s), kernel calls {calls}; hand-off "
              f"{res.raw.handoff}")
    check(out["all_layers"]["handoff"]["prefetch_hits"] > 0,
          "executor overlap on: no prefetch hit")
    check(out["all_layers overlap off"]["handoff"]["prefetch_issued"] == 0,
          "executor overlap off: prefetches issued")
    fed, fed_s, fed_calls = counted(backend="federated",
                                    num_nodes=EXEC_NODES)
    fex, fex_s, fex_calls = counted(backend="executor", schedule="federated",
                                    num_nodes=EXEC_NODES)
    same(fed, fex, "executor federated")
    check(fex_calls == (fed_calls[0] - train_acc_calls, fed_calls[1])
          and fed_calls[1] > 0,
          f"executor federated: kernel calls {fex_calls}, federated "
          f"{fed_calls} (-{train_acc_calls} train accuracy)")
    out["federated"] = {"fit_s": fed_s, "calls": fed_calls}
    out["executor federated"] = {"fit_s": fex_s,
                                 "makespan_s": fex.makespan,
                                 "calls": fex_calls}
    print(f"[17 executor] federated on {EXEC_NODES} streams: bit-identical "
          f"to the federated fit; makespan {fex.makespan:.4f} s (federated "
          f"fit {fed_s:.4f} s); kernel calls {fex_calls}")
    sim = api.simulate(seq, "all_layers", EXEC_NODES)
    main = out["all_layers"]
    print(f"[17 executor] all_layers makespan {main['makespan_s']:.4f} s vs "
          f"sequential fit {seq_s:.4f} s (measured speedup "
          f"{seq_s / main['makespan_s']:.4f}); the simulator on the "
          f"sequential fit's task times predicts {sim.makespan:.4f} s "
          f"(speedup {sim.speedup:.4f}, utilization {sim.utilization:.4f})")

    # one traced run through obs.analyze, on an executor built by hand to
    # show its four streams; the serial bound is a measured 1-node run
    ex = pff_exec.PFFExecutor(cfg, task, "all_layers", EXEC_NODES)
    check(len({id(s) for s in ex.streams}) == EXEC_NODES
          and all(s is not None and d.type == "cuda"
                  for s, d in zip(ex.streams, ex.devices)),
          f"the executor's nodes are not {EXEC_NODES} CUDA streams")
    tr = obs_trace.Tracer()
    traced = ex.run(trace=tr)
    same(seq, traced, "executor all_layers traced")
    serial = pff_exec.PFFExecutor(cfg, task, "sequential", 1).run()
    a = analyze.analyze(tr, measured_makespan=main["makespan_s"])
    fails = analyze.check_invariants(a, main["makespan_s"],
                                     serial_makespan=serial.makespan,
                                     slack=TRACE_SLACK)
    sim_traced = pff.simulate_schedule(traced.records, "all_layers",
                                       EXEC_NODES)
    print(f"[17 trace] critical path {a.critical_path_s:.4f} s, sum of task "
          f"spans {a.sum_task_s:.4f} s, measured makespan "
          f"{main['makespan_s']:.4f} s, serial 1-node run "
          f"{serial.makespan:.4f} s, node busy "
          f"{ {n: round(v, 4) for n, v in a.node_busy.items()} }; the "
          f"simulator on the traced run's records predicts "
          f"{sim_traced.makespan:.4f} s (speedup {sim_traced.speedup:.4f}); "
          f"invariants (slack {TRACE_SLACK}): {fails or 'hold'}")
    check(not fails, f"trace invariants: {fails}")
    check(a.handoff["prefetch_hits"] == traced.handoff["prefetch_hits"],
          "trace prefetch-hit events disagree with the executor's counter")
    out["trace"] = {"critical_path_s": a.critical_path_s,
                    "sum_task_s": a.sum_task_s,
                    "serial_makespan_s": serial.makespan,
                    "sim_makespan_s": sim.makespan,
                    "sim_traced_makespan_s": sim_traced.makespan}

    # 18. resilience at the same config --------------------------------
    shape = dict(splits=cfg.splits, n_layers=n_layers, num_nodes=EXEC_NODES)
    ex_kw = dict(backend="executor", num_nodes=EXEC_NODES)
    res = api.fit(cfg, task, resilience=faults.ResilienceConfig(
        fault_plan=faults.named_plan("crash_once", **shape),
        backoff_base_s=0.001), **ex_kw)
    same(seq, res, "crash_once retry")
    check(res.resilience["retries"] == 1, "crash_once: not one retry")
    print(f"[18 resilience] crash_once: {res.resilience['retries']} retry, "
          f"bit-identical to the sequential fit")
    res = api.fit(cfg, task, resilience=faults.ResilienceConfig(
        fault_plan=faults.named_plan("dead_node", **shape), max_retries=1,
        backoff_base_s=0.001), **ex_kw)
    same(seq, res, "dead_node reassignment")
    st = res.resilience
    check(st["dead_nodes"] == [EXEC_NODES - 1] and st["reassignments"] == 1,
          f"dead_node: {st['dead_nodes']}, {st['reassignments']}")
    print(f"[18 resilience] dead_node: node {st['dead_nodes']} dead after "
          f"{st['retries']} retries, {st['reassignments']} reassignment, "
          f"bit-identical to the sequential fit")
    ck = os.path.join(ROOT, "build", "chip_smoke", "checkpoints")
    shutil.rmtree(ck, ignore_errors=True)
    full = api.fit(cfg, task, resilience=faults.ResilienceConfig(
        checkpoint_dir=ck, keep_last=cfg.splits), **ex_kw)
    same(seq, full, "checkpointed run")
    written = full.resilience["checkpoints_written"]
    check(written == cfg.splits and sorted(os.listdir(ck)) == [
        f"pff_chapter_{c:04d}.npz" for c in range(cfg.splits)],
          f"checkpoints written: {written}, {sorted(os.listdir(ck))}")
    resumed = api.fit(cfg, task, resume_from=os.path.join(
        ck, "pff_chapter_0001.npz"), **ex_kw)
    same(seq, resumed, "resume from chapter 1")
    ck_s = full.resilience["checkpoint_time_s"] / written
    rs_s = resumed.resilience["restore_time_s"]
    size = os.path.getsize(os.path.join(ck, "pff_chapter_0001.npz"))
    print(f"[18 resilience] {written} chapter checkpoints ({size} bytes "
          f"each), {ck_s:.4f} s per chapter to write; resume from chapter "
          f"1: restore {rs_s:.4f} s, bit-identical to the sequential fit; "
          f"makespans checkpointed {full.makespan:.4f} s, resumed "
          f"{resumed.makespan:.4f} s")
    out["resilience"] = {"checkpoint_s_per_chapter": ck_s,
                         "restore_s": rs_s, "manifest_bytes": size}
    kill_dir = os.path.join(ROOT, "build", "chip_smoke", "kill")
    shutil.rmtree(kill_dir, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    killed = subprocess.run(
        [sys.executable, *EXEC_CLI, "--fault-plan", "kill_mid",
         "--checkpoint-dir", kill_dir], capture_output=True, text=True,
        env=env, timeout=300)
    check(killed.returncode == faults.KILL_EXIT,
          f"kill_mid exited {killed.returncode}, not {faults.KILL_EXIT}:\n"
          f"{killed.stdout}\n{killed.stderr[-2000:]}")
    resumed = subprocess.run(
        [sys.executable, *EXEC_CLI, "--resume-from", kill_dir],
        capture_output=True, text=True, env=env, timeout=300)
    check(resumed.returncode == 0 and "bit-exact vs fault-free reference"
          in resumed.stdout, f"resume after kill_mid exited "
          f"{resumed.returncode}:\n{resumed.stdout}\n"
          f"{resumed.stderr[-2000:]}")
    print(f"[18 resilience] kill-then-resume through the CLI: "
          f"{killed.stdout.strip().splitlines()[-1]} (exit "
          f"{killed.returncode}); resumed: "
          + " | ".join(resumed.stdout.strip().splitlines()))
    print(json.dumps({"executor": out}))
    return out["all_layers"]["calls"], exec_main


def phase_repair(dev="cuda"):
    """20. The attention and SSD kernels refuse inputs that need a
    gradient (their results have no grad_fn), launch under no_grad, and
    the plain route (impl="ref") gives the block's grads."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import blocks

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, *hk, 64, generator=gen).to(
        dev, torch.bfloat16) for hk in ((4,), (2,), (2,)))
    xs = [torch.randn(2, 64, 16, 32, generator=gen),
          -torch.rand(2, 64, 16, generator=gen),
          torch.randn(2, 64, 16, generator=gen),
          torch.randn(2, 64, 16, generator=gen)]
    xs = [t.to(dev) for t in xs]
    for name, call, operands in (
            ("flash_attention", lambda: ops.flash_attention(q, k, v),
             (q, k, v)),
            ("mamba2_ssd", lambda: ops.mamba2_ssd(*xs, chunk=32), xs)):
        operands[0].requires_grad_()
        try:
            call()
        except RuntimeError as e:
            check('impl="ref"' in str(e), f"{name}: refusal does not name "
                  f"the plain route: {e}")
        else:
            raise RuntimeError(f"chip_smoke: {name} launched on an input "
                               f"that requires grad")
        with torch.no_grad():
            out = call()
        check(all(not t.requires_grad
                  for t in (out if isinstance(out, tuple) else (out,))),
              f"{name} under no_grad")
        operands[0].requires_grad_(False)
    found = {}
    for name, sub, leaves in (("qwen2-0.5b", "attn", ("wq", "wk", "wv")),
                              ("mamba2-780m", "ssm", ("A_log", "dt_bias",
                                                      "in_proj"))):
        cfg = get_config(name).reduced()
        kind = cfg.groups[0][0][0]
        p = blocks.block_init(torch.Generator(device=dev).manual_seed(0),
                              cfg, kind)
        for n in leaves:
            p[sub][n].requires_grad_()
        x = torch.randn(2, 64, cfg.d_model, device=dev)
        try:
            blocks.block_apply(p, cfg, kind, x, {"impl": "auto"})
        except RuntimeError as e:
            check('impl="ref"' in str(e), f"{name}: {e}")
        else:
            raise RuntimeError(f"chip_smoke: {name} block_apply through the "
                               f"kernel under autograd did not refuse")
        y, _ = blocks.block_apply(p, cfg, kind, x, {"impl": "ref"})
        gs = torch.autograd.grad(torch.sum(torch.square(y - x)),
                                 [p[sub][n] for n in leaves])
        for n, g in zip(leaves, gs):
            found[f"{name}.{n}"] = float(g.abs().max())
            check(bool(torch.isfinite(g).all()) and found[f"{name}.{n}"] > 0,
                  f"{name}: no gradient for {n} through impl='ref'")
    print(f"[20 repair] flash_attention and mamba2_ssd refuse inputs that "
          f"require grad (naming impl=\"ref\"), launch under no_grad; "
          f"block_apply through the kernel under autograd refuses; "
          f"impl='ref' gives max|grad| "
          + ", ".join(f"{k} {v:.3e}" for k, v in found.items()))


def phase_train_while_serve(api, data, base_cfg, kernel, vjp, exec_main,
                            exec_calls, dev="cuda"):
    """19. Train-while-serve at full width: the phase-17 executor cell
    (all_layers on 4 streams) on a ``pff-train`` thread, publishing each
    trained layer into the replica this thread serves from. Returns the
    (ff_dense, ff_dense_bwd) calls of its run, both threads."""
    from repro_torch.core import ff_mlp, pff_exec, strategies
    from repro_torch.core.rng import TorchKey
    from repro_torch.kernels import counts
    from repro_torch.serve.replica import Replica

    cfg = dataclasses.replace(base_cfg, epochs=EXEC_EPOCHS,
                              splits=EXEC_SPLITS)
    task = data.mnist_like(seed=0, n_train=FIT_TRAIN, n_test=FIT_TEST)
    n_layers = len(cfg.layer_sizes) - 1
    counts.reset(kernel, vjp)
    t0 = time.perf_counter()
    res = api.serve(cfg, task, schedule="all_layers", num_nodes=EXEC_NODES,
                    traffic="uniform", rate=TWS_RATE, max_batch=64,
                    final_probe=TWS_PROBE, device=dev)
    wall = time.perf_counter() - t0
    launches = (kernel.LAUNCHES.total, vjp.LAUNCHES.total)
    fwd = kernel.LAUNCHES.by_thread
    bwd = vjp.LAUNCHES.by_thread
    slo = res.slo
    versions = [s["version"] for s in res.swaps]
    final = [r for r in res.raw.requests if r.version == cfg.splits - 1]
    batches = res.raw.batches_scored
    print(f"[19 train-while-serve] all_layers on {EXEC_NODES} streams + the "
          f"serving stream: {slo['requests']} requests at "
          f"{slo['throughput_rps']:.2f} req/s ({TWS_RATE} offered), p50 "
          f"{slo['latency_p50_ms']:.4f} ms, p99 {slo['latency_p99_ms']:.4f} "
          f"ms, shed rate {slo['shed_rate']:.4f}, staleness mean "
          f"{slo['staleness_mean_s']:.6f} s max {slo['staleness_max_s']:.6f}"
          f" s, {batches} batches; swaps {versions}, violations "
          f"{slo['consistency_violations']}; train_s "
          f"{res.timings['train_s']:.4f} (makespan {res.fit.makespan:.4f} s"
          f") vs phase 17's all_layers makespan {exec_main.makespan:.4f} s;"
          f" wall {wall:.4f} s; ff_dense calls by thread {fwd}, "
          f"ff_dense_bwd {bwd}")
    check(slo["consistency_violations"] == 0,
          f"train-while-serve: {slo['consistency_violations']} violations")
    check(versions == list(range(-1, cfg.splits)),
          f"train-while-serve: swap versions {versions}")
    check(len(final) >= TWS_PROBE, f"train-while-serve: {len(final)} "
          f"requests served at the final version, < {TWS_PROBE}")
    check(pff_exec.params_bit_equal(exec_main.params, res.fit.params)
          and res.fit.test_acc == exec_main.test_acc,
          "train-while-serve: the trained params differ from phase 17's "
          "all_layers run (publication must be read-only)")
    # the final version's served predictions: re-scored through a
    # replica on those params (batches padded to max_batch, as served, so
    # each row meets the same kernel shapes) they come out the same; and
    # against the plain path's class scores, on the rows whose top-2
    # margin exceeds twice the largest kernel-vs-plain score difference
    # (where the two cannot disagree)
    good = strategies.goodness.get(cfg.goodness_fn)
    replica = Replica(cfg.num_classes, max_batch=64,
                      eval_mode=good.eval_mode(cfg))
    replica.install(0, res.fit.params, [0], time.perf_counter())
    xs = np.stack([r.x for r in final])
    served = torch.as_tensor(np.concatenate(
        [replica.score(xs[i:i + 64]) for i in range(0, len(xs), 64)]))
    with torch.no_grad():
        scores = ff_mlp.class_scores(
            res.fit.params, torch.as_tensor(xs, device=dev),
            cfg.num_classes, good.eval_mode(cfg), impl="ref").cpu()
    pred = torch.tensor([r.pred for r in final])
    err = float((served - scores).abs().max())
    margin = top2_margin(scores)
    decided = margin > 2 * err
    same = pred == scores.argmax(1)
    q = torch.quantile(margin, torch.tensor([0.0, 0.5, 1.0])).tolist()
    print(f"[19 train-while-serve] final version ({len(final)} requests): "
          f"re-scored through the replica, predictions equal the served "
          f"ones: {bool(torch.equal(served.argmax(1).int(), pred.int()))};"
          f" scores kernel vs plain max|diff| {err:.3e} (max|score| "
          f"{float(scores.abs().max()):.4f}); served equal the plain "
          f"path's argmax on {int(same[decided].sum())}/"
          f"{int(decided.sum())} rows with top-2 margin > 2 x that, on "
          f"{int(same.sum())}/{len(final)} in all; margins min/median/max "
          f"{q}, {int((margin > F32_MARGIN).sum())} above {F32_MARGIN}")
    check(torch.equal(served.argmax(1).int(), pred.int()),
          "train-while-serve: re-scored predictions differ from the served")
    check(int(decided.sum()) > 0 and bool(same[decided].all()),
          "train-while-serve: no decided row, or served predictions differ "
          "from the plain path on decided rows")
    # serving accuracy across the swaps: the served windows by version
    # (a few hundred requests each, so printed, not gated), and the
    # served model's test accuracy against the untrained model's (the
    # version -1 snapshot) on the same 1000 test rows, gated
    untrained = ff_mlp.init(cfg, TorchKey(cfg.seed), dev)
    acc0 = ff_mlp.accuracy(untrained, task.x_test, task.y_test,
                           cfg.num_classes, good.eval_mode(cfg),
                           impl=ff_mlp.kernel_impl(cfg))
    curve = res.accuracy_by_version
    print(f"[19 train-while-serve] served accuracy by version (requests): "
          + ", ".join(f"{v}: {r['accuracy']:.4f} ({r['n']})"
                      for v, r in curve.items())
          + f"; test accuracy final {res.fit.test_acc:.4f} vs untrained "
          f"{acc0:.4f}")
    check(res.fit.test_acc > acc0, f"train-while-serve: the served model's "
          f"test accuracy {res.fit.test_acc} is not above the untrained "
          f"model's {acc0}")
    # the backward kernel launches on autograd's device thread, which
    # runs the training thread's backward passes
    check(fwd.get("pff-train") == exec_calls[0]
          and sum(bwd.values()) == exec_calls[1],
          f"training: calls ({fwd.get('pff-train')}, {bwd}), phase 17's "
          f"all_layers run {exec_calls}")
    print(json.dumps({"train_while_serve": {
        "slo": slo, "train_s": res.timings["train_s"],
        "serve_s": res.timings["serve_s"], "makespan_s": res.fit.makespan,
        "exec_makespan_s": exec_main.makespan, "batches": batches,
        "accuracy_by_version": curve, "test_acc": res.fit.test_acc,
        "untrained_test_acc": acc0,
        "ff_dense_calls": fwd, "ff_dense_bwd_calls": bwd}}))
    return launches


def mixer_out(params, factor, block=None):
    """``params`` with the mixer output projection (attention ``wo``, SSD
    ``out_proj``) of every block, or of ``block`` alone, scaled by
    ``factor``; the rest shared."""
    (blk,), = params["groups"]
    key, leaf = ("attn", "wo") if "attn" in blk else ("ssm", "out_proj")
    w = blk[key][leaf]
    if block is None:
        w = w * factor
    else:
        w = w.clone()
        w[block] *= factor
    blk = {**blk, key: {**blk[key], leaf: w}}
    return {**params, "groups": ((blk,),)}


def lm_fit(api, cfg, source, counter, **kw):
    """One counted LM fit: (FitResult, kernel calls, wall s)."""
    from repro_torch.kernels import counts

    counts.reset(counter)
    t0 = time.perf_counter()
    res = api.fit(cfg, source, **kw)
    torch.cuda.synchronize()
    return res, counter.LAUNCHES.total, time.perf_counter() - t0


def phase_lm_train(api, data, name, *, chapters, executor, dev="cuda"):
    """21-22. LM chapter training at full width and depth (bf16): the
    sequential fit through the kernels (no-grad forwards) and through the
    plain route; for qwen2-0.5b also the executor (all_layers,
    single_layer on 4 streams, bit-identical to the sequential fit).
    Returns the main run's (the sequential fit's) kernel calls."""
    from repro_torch.configs import get_config
    from repro_torch.core import pff_lm, train
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd

    cfg = get_config(name)
    counter = fa if cfg.groups[0][0][0] == "attn" else ssd
    n_blocks = cfg.groups[0][1]
    C, s = chapters, LM_STEPS
    calls = C * s * (sum(range(n_blocks)) + n_blocks) + n_blocks
    phase = 21 if counter is fa else 22
    tag = f"[{phase} lm-train] {name}"
    source = data.text_source(vocab=cfg.vocab, seq_len=LM_SEQ, seed=0)
    kw = dict(chapters=C, steps_per_chapter=s, batch=LM_TRAIN_BATCH,
              device=dev)
    ev = torch.as_tensor(source.blocks("val", 16, seed=321), device=dev)
    init_ce = float(train.eval_ce(pff_lm.init_params(cfg, 0, dev), cfg, ev))
    seq, seq_calls, seq_s = lm_fit(api, cfg, source, counter, **kw)
    check(seq_calls == calls, f"{name}: sequential fit made {seq_calls} "
          f"{counter.__name__.split('.')[-1]} kernel calls, expected {calls}")
    check(np.isfinite(seq.eval_ce) and seq.eval_ce < init_ce,
          f"{name}: eval CE {seq.eval_ce} not finite or not below the "
          f"untrained model's {init_ce}")
    out = {"sequential": {"wall_s": seq_s, "makespan_s": seq.makespan,
                          "calls": seq_calls, "eval_ce": seq.eval_ce},
           "init_eval_ce": init_ce}
    print(f"{tag} bf16, {C} chapters x {s} steps, batch {LM_TRAIN_BATCH}, "
          f"seq {LM_SEQ}: sequential fit {seq_s:.4f} s (makespan "
          f"{seq.makespan:.4f} s), {seq_calls} kernel calls (expected "
          f"{calls}); eval CE {seq.eval_ce:.6f} vs untrained {init_ce:.6f}")
    # the same params both ways, and the controls
    ce_kernel = float(train.eval_ce(seq.params, cfg, ev))
    ce_plain = float(train.eval_ce(seq.params, cfg, ev, impl="ref"))
    ce_drop = float(train.eval_ce(mixer_out(seq.params, 0.0, n_blocks - 1),
                                  cfg, ev, impl="ref"))
    ce_scale = float(train.eval_ce(mixer_out(seq.params, LM_CE_SCALE), cfg,
                                   ev, impl="ref"))
    sound, control = abs(ce_kernel - ce_plain), abs(ce_drop - ce_plain)
    out["same_params"] = {"eval_ce_kernel": ce_kernel,
                          "eval_ce_plain": ce_plain,
                          "eval_ce_last_mixer_dropped": ce_drop,
                          "eval_ce_mixers_scaled": ce_scale,
                          "kernel_vs_plain": sound,
                          "control_vs_plain": control,
                          "limit": LM_SAME_CE_TOL}
    print(f"{tag} the fit's params scored both ways: eval CE through the "
          f"kernels {ce_kernel:.6f}, plain route {ce_plain:.6f}, |diff| "
          f"{sound:.3e} (<= {LM_SAME_CE_TOL}); control, the last block's "
          f"mixer dropped: {ce_drop:.6f}, |diff| {control:.3e} (> "
          f"{LM_SAME_CE_TOL}); every mixer output x {LM_CE_SCALE}: "
          f"{ce_scale:.6f}, |diff| {abs(ce_scale - ce_plain):.3e}")
    check(ce_kernel == seq.eval_ce, f"{name}: eval CE of the fit's params "
          f"{ce_kernel} differs from the fit's own {seq.eval_ce}")
    check(sound <= LM_SAME_CE_TOL < control, f"{name}: eval CE through the "
          f"kernels vs the plain route on the same params {sound}, the "
          f"control {control}, limit {LM_SAME_CE_TOL}")
    if executor:
        sim = api.simulate(seq, "all_layers", EXEC_NODES)
        sim_sl = api.simulate(seq, "single_layer", EXEC_NODES)
        for sched in ("all_layers", "single_layer"):
            res, n, wall = lm_fit(api, cfg, source, counter,
                                  backend="executor", schedule=sched,
                                  num_nodes=EXEC_NODES, **kw)
            check(pff_lm.lm_params_bit_equal(seq.params, res.params)
                  and res.eval_ce == seq.eval_ce,
                  f"{name} executor {sched}: params or eval CE differ from "
                  f"the sequential fit's")
            check(n == calls, f"{name} executor {sched}: {n} kernel calls, "
                  f"expected {calls}")
            out[sched] = {"wall_s": wall, "makespan_s": res.makespan,
                          "calls": n, "handoff": res.raw.handoff}
            print(f"{tag} executor {sched} on {EXEC_NODES} streams: "
                  f"bit-identical to the sequential fit (eval CE equal); "
                  f"makespan {res.makespan:.4f} s (fit {wall:.4f} s), "
                  f"{n} kernel calls; hand-off {res.raw.handoff}")
            del res
        out["sim"] = {"all_layers_s": sim.makespan,
                      "all_layers_speedup": sim.speedup,
                      "single_layer_s": sim_sl.makespan,
                      "single_layer_speedup": sim_sl.speedup}
        print(f"{tag} the simulator on the sequential fit's task times "
              f"predicts all_layers {sim.makespan:.4f} s (speedup "
              f"{sim.speedup:.4f}), single_layer {sim_sl.makespan:.4f} s "
              f"(speedup {sim_sl.speedup:.4f}) on {EXEC_NODES} nodes")
    plain, plain_calls, plain_s = lm_fit(api, cfg, source, counter,
                                         impl="ref", **kw)
    diff = abs(plain.eval_ce - seq.eval_ce)
    out["plain"] = {"wall_s": plain_s, "makespan_s": plain.makespan,
                    "calls": plain_calls, "eval_ce": plain.eval_ce}
    print(f"{tag} plain route throughout: fit {plain_s:.4f} s (makespan "
          f"{plain.makespan:.4f} s), {plain_calls} kernel calls; eval CE "
          f"{plain.eval_ce:.6f}, |kernel - plain| {diff:.3e} "
          f"(<= {LM_CE_TOL})")
    check(plain_calls == 0, f"{name}: the plain route launched a kernel")
    check(np.isfinite(plain.eval_ce) and plain.eval_ce < init_ce,
          f"{name}: plain-route eval CE {plain.eval_ce}")
    check(diff <= LM_CE_TOL, f"{name}: eval CE kernel route vs plain route "
          f"{diff} > {LM_CE_TOL}")
    del plain
    print(json.dumps({"lm_train": name, **out}))
    return seq_calls


def joint_ff_steps(data, name, dev="cuda"):
    """21. Two joint-FF steps (sumsq, random negatives) and one adaptive
    step at the full config: losses finite, params moved, and the
    adaptive step's no-grad forward through the attention kernel."""
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.core import pff_lm, train
    from repro_torch.kernels import counts, flash_attention as counter

    cfg = get_config(name)
    n_blocks = cfg.groups[0][1]
    source = data.text_source(vocab=cfg.vocab, seq_len=LM_SEQ, seed=0)
    out = {}
    blk = source.blocks("train", 2 * LM_TRAIN_BATCH, seed=7)
    for mode, steps in (("random", 2), ("adaptive", 1)):
        c = dataclasses.replace(cfg, ff=dataclasses.replace(
            cfg.ff, goodness="sumsq", neg_mode=mode))
        params = pff_lm.init_params(c, 0, dev)
        embed0 = params["embed"].clone()
        w0 = {k: t.clone() for k, t in params["groups"][0][0]["attn"].items()}
        opt = optim.adam_init(params)
        step = train.make_ff_train_step(c, lr=1e-3)
        t0 = time.perf_counter()
        metrics = []
        for i in range(steps):
            counts.reset(counter)
            batch = {"tokens": torch.as_tensor(
                blk[i * LM_TRAIN_BATCH:(i + 1) * LM_TRAIN_BATCH], device=dev)}
            params, opt, m = step(params, opt, batch, i + 1)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counter.LAUNCHES.total
        attn = params["groups"][0][0]["attn"]
        moved = (not torch.equal(embed0, params["embed"])
                 and all(not torch.equal(w0[k], attn[k]) for k in w0))
        check(all(np.isfinite(v) for m in metrics for v in m.values()),
              f"joint FF {mode}: non-finite loss {metrics}")
        check(moved, f"joint FF {mode}: params did not move")
        want = n_blocks if mode == "adaptive" else 0
        check(launched == want, f"joint FF {mode}: {launched} kernel calls "
              f"in the last step, expected {want}")
        out[mode] = {"steps": steps, "wall_s": wall, "metrics": metrics,
                     "kernel_calls_last_step": launched}
        del params, opt, embed0, w0, attn
        torch.cuda.empty_cache()
        print(f"[21 lm-train] joint FF ({mode} negatives, sumsq) {steps} "
              f"step(s) in {wall:.4f} s: losses finite, params moved; "
              f"{launched} kernel calls in the last step (the no-grad "
              f"forward: {want}); last metrics "
              f"{ {k: round(v, 4) for k, v in metrics[-1].items()} }")
    print(json.dumps({"lm_joint_ff": name, **out}))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    # phases 17-18 run under torch.use_deterministic_algorithms, where
    # cuBLAS needs a pinned workspace, set before CUDA starts (inherited
    # by the executor's CLI in phase 18)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import api, data, optim
    from repro_torch.configs.ff_mlp import PAPER_MLP
    from repro_torch.core import ff_mlp
    from repro_torch.core.rng import TorchKey
    from repro_torch.kernels import _build, counts, ff_dense as kernel
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
    for line in ptxas_summary(_build.build_log()):
        print(f"[2 ptxas] {line}")
    # the 3xTF32 kernels' products run on the tensor cores: HMMA in SASS
    mma = sass_mma_counts(_build.library_path(),
                          ("ff_dense.cu", "mamba2_ssd.cu"))
    check(mma is not None, "cuobjdump (CUDA toolkit) not found beside nvcc "
          "or failed: the 3xTF32 kernels' SASS cannot be checked")
    for name, n in mma.items():
        print(f"[2 sass] {name}: {n} HMMA instructions")
    # each 3xTF32 kernel (plain or mangled names) issues some
    for name in ("gemm_split", "ssd_scores", "ssd_states", "ssd_output"):
        check(any(name in k and n > 0 for k, n in mma.items()),
              f"{name} has no tensor-core instruction in its SASS")

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
    for M, K, N in [TRAIN_SHAPES[1], SERVING_SHAPES[1]]:
        x, w, b = make_inputs(gen, M, K, N, torch.float32)
        for norm in (False, True):
            first = kernel.ff_dense(x, w, b, norm=norm)
            again = kernel.ff_dense(x, w, b, norm=norm)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"ff_dense: two calls at {(M, K, N)} norm={norm} differ")
        print(f"[3 check] ff_dense {(M, K, N)}: a second call gives "
              f"bit-identical y and g (norm off/on; "
              f"{kernel._fwd_split(M, K, N)[0]} slices of K)")
        # against a float64 truth: the tensor cores truncate each mma's
        # sum toward zero, which a mean signed error on y > 0 shows as a
        # negative bias
        y, g = kernel.ff_dense(x, w, b)
        y64 = torch.relu(x.double() @ w.double() + b.double())
        g64 = (y64 * y64).sum(1)
        yp, gp = kernel.ff_dense_plain(x, w, b)
        live = y64 > 0
        bias = float((y.double() - y64)[live].mean() / y64[live].mean())
        ey, eg = scaled_err(y, y64), scaled_err(g, g64)
        print(f"[3 f64] ff_dense {(M, K, N)} against float64: kernel y err "
              f"{ey:.3e}, g err {eg:.3e}, mean signed y error {bias:.3e} of "
              f"mean y; plain y err {scaled_err(yp, y64):.3e}, g err "
              f"{scaled_err(gp, g64):.3e}")
        check(ey <= TOL[torch.float32][0] and eg <= TOL[torch.float32][1],
              f"ff_dense at {(M, K, N)} disagrees with float64")

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
                  f"({bound_by}; 3xTF32; f32 FMA "
                  f"{fma_ms(M, K, N, norm):.4f} ms)")
        print(f"[4 time] ff_dense {(M, K, N)} by block width: "
              + tile_times(kernel, x, w, b, flush))
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
        before = kernel.LAUNCHES.total
        s_k = ff_mlp.class_scores(params, xb, PAPER_MLP.num_classes, mode,
                                  impl="auto")
        s_r = ff_mlp.class_scores(params, xb, PAPER_MLP.num_classes, mode,
                                  impl="ref")
        torch.cuda.synchronize()
        check(kernel.LAUNCHES.total - before == len(params["layers"]),
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
    counts.reset(kernel)
    res = api.serve(PAPER_MLP, task, params=p_sumsq, traffic="uniform",
                    n_requests=SERVE_REQUESTS, rate=2000.0, max_batch=64)
    launches = kernel.LAUNCHES.total
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
            before = vjp.LAUNCHES.total
            gk = grads(fused, x, w, b)
            torch.cuda.synchronize()
            check(vjp.LAUNCHES.total - before == 1,
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
    for M, K, N in TRAIN_SHAPES:
        x, w, b = make_inputs(gen, M, K, N, torch.float32)
        library_ms = time_ms(lambda: torch.addmm(b, x, w), flush)
        for norm in (False, True):
            y, g = kernel.ff_dense(x, w, b, norm=norm)
            yp, gp = kernel.ff_dense_plain(x, w, b, norm=norm)
            max_abs_err = float(max((y - yp).abs().max(),
                                    (g - gp).abs().max()))
            ey, eg = scaled_err(y, yp), scaled_err(g, gp)
            tol_y, tol_g = TOL[torch.float32]
            print(f"[9 check] ff_dense {(M, K, N)} norm={norm}: y err "
                  f"{ey:.3e} (<= {tol_y}), g err {eg:.3e} (<= {tol_g})")
            check(ey <= tol_y and eg <= tol_g, f"ff_dense disagrees with "
                  f"its plain version at {(M, K, N)} norm={norm}")
            kernel_ms = time_ms(lambda: kernel.ff_dense(x, w, b, norm=norm),
                                flush)
            plain_ms = time_ms(
                lambda: kernel.ff_dense_plain(x, w, b, norm=norm), flush)
            bound_ms, bound_by = bound(M, K, N, norm)
            # each launch alone, cold L2 (the finish alone reads the
            # scratch of a fresh allocation: timing only)
            parts = {name: time_ms(lambda: kernel._launch(x, w, b, norm, bit),
                                   flush)
                     for name, bit in (("gemm_split", kernel.GEMM),
                                       ("finish_rows", kernel.FINISH))}
            fwd_rows.append({
                "name": "ff_dense", "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES, "shape": [M, K, N],
                "norm": norm, "dtype": "float32", "launches": None,
                "max_abs_err": max_abs_err, "ms": kernel_ms,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
                "library": "torch.addmm(b, x, w), TF32 off: matmul only",
                "parts_ms": parts})
            print(f"[9 time] ff_dense {(M, K, N)} norm={norm} (training M; "
                  f"{kernel._fwd_split(M, K, N)[0]} slices of K): kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, addmm "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; 3xTF32; f32 FMA "
                  f"{fma_ms(M, K, N, norm):.4f} ms); each launch alone (cold "
                  f"L2): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
        print(f"[9 time] ff_dense {(M, K, N)} by block width: "
              + tile_times(kernel, x, w, b, flush))
    fwd_step_ms = next(r["ms"] for r in fwd_rows
                       if r["shape"] == list(TRAIN_SHAPES[1]) and not r["norm"])
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
          f"{fwd_step_ms:.4f} ms + backward {bwd_rows[1]['ms']:.4f} "
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
        before = vjp.LAUNCHES.total
        ff_mlp.train_layer_chapter(
            lp, optim.adam_init(lp), xs[0], xs[1], lrs, TorchKey(5),
            batch=64, epochs=1, theta=2.0, peer_w=0.0, impl=impl)
        out[impl] = (lp, vjp.LAUNCHES.total - before)
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
        counts.reset(kernel, vjp)
        t0 = time.perf_counter()
        res = api.fit(cfg, fit_task, backend="sequential")
        fit_s = time.perf_counter() - t0
        fwd_calls, bwd_calls = kernel.LAUNCHES.total, vjp.LAUNCHES.total
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
        if (shape, decay) == (MAMBA_SSD, "mild"):
            again = ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk)
            torch.cuda.synchronize()
            check(torch.equal(y, again[0]) and torch.equal(hT, again[1]),
                  f"mamba2_ssd: two calls at {shape} differ")
            print(f"[13 check] mamba2_ssd {shape}: a second call gives "
                  f"bit-identical y and hT")
            del again
        del xbar, dA, b, c, y, hT, yp, hp

    # 14. timing of both beside their bounds -----------------------------
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    lm_rows = []
    for shape in TIMED_ATTN:
        lm_rows += attention_rows(gen, shape, fa_errs, flush)
    B, S, H, hd, N, chunk = MAMBA_SSD
    xbar, dA, b, c = ssd_inputs(gen, B, S, H, hd, N, "mild")
    kernel_ms = time_ms(lambda: ssd.mamba2_ssd(xbar, dA, b, c, chunk=chunk),
                        flush)
    plain_ms = time_ms(
        lambda: ssd.mamba2_ssd_plain(xbar, dA, b, c, chunk=chunk), flush)
    ops, nbytes = ssd_bound(B, S, H, hd, N, chunk)
    bound_ms, bound_by = roofline(0, nbytes, tf32_flops=3 * ops)
    ssd_fma_ms, _ = roofline(ops, nbytes)
    # each launch alone, cold L2 (a later launch alone reads the scratch
    # of a fresh allocation: timing only)
    parts = {name: time_ms(lambda: ssd._launch(xbar, dA, b, c, chunk, bit),
                           flush)
             for name, bit in (("scores", ssd.SCORES), ("states", ssd.STATES),
                               ("state_pass", ssd.STATE_PASS),
                               ("output", ssd.OUTPUT))}
    lm_rows.append({
        "name": "mamba2_ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "shape": [B, S, H, hd, N, chunk],
        "dtype": "float32", "launches": None,
        "max_abs_err": ssd_errs[MAMBA_SSD + ("mild",)], "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "parts_ms": parts})
    print(f"[14 time] mamba2_ssd {MAMBA_SSD}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"3xTF32; f32 FMA {ssd_fma_ms:.4f} ms); no library call computes "
          f"the scan; each launch alone (cold L2): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()))
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
        counts.reset(fa, ssd)
        res = run_lm(cfg, params, "auto")
        launches = counter.LAUNCHES.total
        lm_launches[op] = launches
        check(launches == calls and other.LAUNCHES.total == 0,
              f"{name}: lm_decode made {launches} {op} kernel calls (and "
              f"{other.LAUNCHES.total} of the other op), expected {calls} "
              f"and 0")
        res_ref = run_lm(cfg, params, "ref")
        res_ref2 = run_lm(cfg, params, "ref")
        res2 = run_lm(cfg, params, "auto")
        check(counter.LAUNCHES.total == 2 * calls
              and other.LAUNCHES.total == 0,
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
        lk, lr = lm_gate(name, cfg, params, prompts, LM_PROMPT + LM_GEN,
                         calls, "[15 lm]", op)
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
        del params, res, res2, res_ref, res_ref2

        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                               cfg32)
        for impl in ("auto", "ref"):
            run_lm(cfg32, p32, impl, gen=2)
        res = run_lm(cfg32, p32, "auto")
        res_ref = run_lm(cfg32, p32, "ref")
        lk, lr = lm_gate(name, cfg32, p32, prompts, LM_PROMPT + LM_GEN, calls,
                         "[15 lm] f32", op)
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

    # 16. the SSD kernel at the reduced mamba2 sizes, and its LM path -------
    rows.append(phase_reduced_ssd(gen, data))

    # 17-18. the PFF executor at full width, and its resilience ------------
    torch.use_deterministic_algorithms(True)
    exec_calls, exec_main = phase_executor(api, data, PAPER_MLP, kernel, vjp)
    # 19. train-while-serve: the same cell, served while it trains --------
    tws_calls = phase_train_while_serve(api, data, PAPER_MLP, kernel, vjp,
                                        exec_main, exec_calls)
    torch.use_deterministic_algorithms(False)
    for row in fwd_rows:
        row["launches"] += exec_calls[0] + tws_calls[0]
    for row in bwd_rows:
        row["launches"] += exec_calls[1] + tws_calls[1]
    del exec_main

    # 20. the attention and SSD kernels refuse autograd inputs -------------
    phase_repair()

    # 21-22. LM chapter training at full width and depth -----------------
    lm_train_calls = {}
    for name, (op, _) in LM_CALLS.items():
        # the bit-exact executor gates run deterministic; the joint steps
        # and mamba2 (no bit-exact gate) do not
        torch.use_deterministic_algorithms(name == "qwen2-0.5b")
        lm_train_calls[op] = phase_lm_train(
            api, data, name, chapters=LM_CHAPTERS[name],
            executor=name == "qwen2-0.5b")
        torch.use_deterministic_algorithms(False)
        if name == "qwen2-0.5b":
            joint_ff_steps(data, name)
        torch.cuda.empty_cache()
    for row in lm_rows:
        row["launches"] += lm_train_calls[row["name"]]

    # 23-24. the dense and hybrid configs: the main path at full size, and
    # the reduced windowed ones -------------------------------------------
    family_calls = phase_lm_families(data) + phase_reduced_families(data)
    # 25-26. the MoE configs: the main path at published widths, and the
    # reduced ones in both MoE branches ------------------------------------
    from repro_torch.kernels import registry
    registry.flash_attention.register("nudged", nudged_attention)
    family_calls += phase_moe_lm(data) + phase_reduced_moe(data)
    for row in lm_rows:
        if row["name"] == "flash_attention":
            row["launches"] += family_calls

    # 27. isolation --------------------------------------------------------
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not leaked, f"JAX or the JAX package was imported: {leaked}")
    print("[27 isolation] no jax, no repro module loaded")
    print(f"[wall] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
