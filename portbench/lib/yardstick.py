"""Peaks of the card, and operations and bytes from shapes.

Frozen copies, kept with the benchmark so that a change to the program
cannot move them:

- the H100 SXM peaks of ``chip_smoke.py:350-353`` (NVIDIA's data sheet,
  dense rates, 700 W), with f32 products on the tensor cores as 3xTF32,
  three TF32 products for each, at a third of the TF32 rate;
- ``chip_smoke.py::fwd_work`` / ``bound`` (``ff_dense``), ``bwd_bound``
  (``ff_dense_bwd``) and ``fa_pairs`` / ``fa_bound``
  (``flash_attention``). One change to ``bwd_bound``: its products count
  at the 3xTF32 rate, as the forward's do, and only the products that
  the caller uses (``ff_dense_bwd_work(need_dx=False)``), so that a
  backward moved onto the tensor cores reads under 100% and not above;
- the model operations of one chapter of each cell's algorithm
  (``mlp_chapter_flops``, ``lm_chapter_flops``), the work that the
  algorithm needs and no schedule's or kernel's extra work.
"""
from __future__ import annotations

import numpy as np

F32_PEAK = 67e12          # f32 FMA outside the tensor cores
TF32_PEAK = 495e12        # TF32 on the tensor cores
F32X3_PEAK = TF32_PEAK / 3    # f32-exact products as 3xTF32
BF16_PEAK = 989e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops, nbytes, peak):
    """The least time the card needs: the larger of operations over the
    peak and bytes over the memory rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def ff_dense_work(M, K, N, norm, itemsize=4):
    """(product operations, elementwise operations, bytes) of one
    ``ff_dense`` call: x @ w, the epilogue's bias, relu, square and sum
    (and the divide with norm), each input read once and each output
    written once (g in f32)."""
    return (2 * M * K * N, 4 * M * N + (M * N if norm else 0),
            itemsize * (M * K + K * N + N + M * N) + 4 * M)


def ff_dense_roofline_s(M, K, N, norm, itemsize=4):
    mm, elementwise, nbytes = ff_dense_work(M, K, N, norm, itemsize)
    peak = F32X3_PEAK if itemsize == 4 else BF16_PEAK
    return max(mm / peak + elementwise / F32_PEAK,
               nbytes / HBM_BYTES_PER_S)


def ff_dense_bwd_work(M, K, N, need_dx, itemsize=4):
    """(product operations, bytes) of one ``ff_dense_bwd`` call that the
    caller needs: dw = x^T dy (and dx = dy w^T when the input needs a
    gradient); x, y, dy_out, dg read once (w too for dx), dw, db (and dx)
    written once. Layer-local FF never needs dx."""
    flops = 2 * M * K * N * (2 if need_dx else 1)
    nbytes = itemsize * (M * K + 2 * M * N + K * N) + 4 * (M + N)
    if need_dx:
        nbytes += itemsize * (K * N + M * K)
    return flops, nbytes


def ff_dense_bwd_roofline_s(M, K, N, need_dx=False, itemsize=4):
    flops, nbytes = ff_dense_bwd_work(M, K, N, need_dx, itemsize)
    peak = F32X3_PEAK if itemsize == 4 else BF16_PEAK
    return roofline_s(flops, nbytes, peak)


def attention_pairs(Sq, Sk, causal, window=None):
    """(query, key) pairs one head reads: row i sees keys j <= i when
    causal and i - j < window when a window is given."""
    i = np.arange(Sq)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0 * i
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1)
    seen = np.maximum(hi - lo + 1, 0)
    return int(np.where(seen > 0, seen, Sk).sum())


def flash_attention_work(B, Sq, Sk, H, KV, hd, causal, itemsize,
                         window=None):
    """(operations, bytes): Q K^T and P V over the visible pairs, q, k, v
    read once and the output written once."""
    pairs = B * H * attention_pairs(Sq, Sk, causal, window)
    nbytes = itemsize * hd * (2 * B * Sq * H + 2 * B * Sk * KV)
    return 4 * pairs * hd, nbytes


def flash_attention_roofline_s(B, Sq, Sk, H, KV, hd, causal, itemsize,
                               window=None):
    """bf16 products at the bf16 rate, f32 ones at the f32 FMA rate."""
    flops, nbytes = flash_attention_work(B, Sq, Sk, H, KV, hd, causal,
                                         itemsize, window)
    peak = BF16_PEAK if itemsize == 2 else F32_PEAK
    return roofline_s(flops, nbytes, peak)


# ---------------------------------------------------------------------------
# Model operations of one chapter
# ---------------------------------------------------------------------------

def mlp_chapter_flops(sizes, batch, n_train, num_classes, steps=1):
    """One chapter of the sequential FF chapter schedule
    (``pff.run_chapter_schedule``), whatever schedule runs it: every
    layer's forward and weight gradient for each of its ``steps`` grad
    steps, 4 M K N with M = 2 * batch (positives and negatives stacked);
    the layer inputs' forward for the next layer, once; AdaptiveNEG's
    scoring of ``num_classes`` overlays of the train set, once."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    train = sum(4 * 2 * batch * k * n for k, n in pairs) * steps
    inputs = sum(2 * 2 * n_train * k * n for k, n in pairs[:-1])
    scoring = sum(2 * num_classes * n_train * k * n for k, n in pairs)
    return train + inputs + scoring


def lm_block_flops(cfg, rows, seq):
    """One dense GQA block's forward over ``rows`` sequences of ``seq``
    tokens: its projections and gated MLP, and causal attention over the
    visible pairs."""
    d, H, KV, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv"],
                        cfg["head_dim"], cfg["d_ff"])
    T = rows * seq
    linear = 2 * T * (d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff)
    attn = 4 * rows * H * attention_pairs(seq, seq, True) * hd
    return linear + attn


def lm_chapter_flops(cfg, batch, seq, steps=1):
    """One chapter of ``pff_lm.train_chapters``: for each block k, its
    ``steps`` grad steps on 2 * batch rows (positives and their
    corruptions), each a frozen forward through blocks < k and the
    block's forward and backward (3 forwards); then the head task: a
    frozen forward through every block on ``batch`` rows, and the tied
    softmax's forward and its two backward products."""
    L, d = cfg["num_layers"], cfg["d_model"]
    vp = -(-cfg["vocab"] // 128) * 128
    blk2 = lm_block_flops(cfg, 2 * batch, seq)
    blocks = steps * sum(k * blk2 + 3 * blk2 for k in range(L))
    head = L * lm_block_flops(cfg, batch, seq) + 3 * 2 * batch * seq * d * vp
    return blocks + head
