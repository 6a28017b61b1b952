"""The yardstick's counts equal hand counts at small shapes, and the
frozen copies of the program's generators and key rule give the
program's numbers."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.lib import keys, traffic, yardstick as ys  # noqa: E402


def test_ff_dense_work_by_hand():
    # x (2, 3) @ w (3, 4): 2*2*3*4 products; bias, relu, square, sum:
    # 4 per output; norm adds a divide per output
    assert ys.ff_dense_work(2, 3, 4, False) == (48, 32, 4 * (6 + 12 + 4 + 8) + 8)
    assert ys.ff_dense_work(2, 3, 4, True)[1] == 40


def test_ff_dense_bwd_work_counts_dx_only_when_asked():
    # dw = x^T dy: 2*M*K*N; reads x, y, dy_out, w? (w only for dx)
    flops, nbytes = ys.ff_dense_bwd_work(2, 3, 4, need_dx=False)
    assert flops == 48
    assert nbytes == 4 * (6 + 2 * 8 + 12) + 4 * (2 + 4)
    flops2, nbytes2 = ys.ff_dense_bwd_work(2, 3, 4, need_dx=True)
    assert flops2 == 96 and nbytes2 == nbytes + 4 * (12 + 6)


def test_f32_products_count_at_the_3xtf32_rate():
    # big enough to be bound by operations
    M = K = N = 4096
    t = ys.ff_dense_bwd_roofline_s(M, K, N)
    assert t == pytest.approx(2 * M * K * N / (495e12 / 3))


def test_attention_pairs_by_hand():
    assert ys.attention_pairs(4, 4, causal=True) == 1 + 2 + 3 + 4
    assert ys.attention_pairs(4, 4, causal=False) == 16
    assert ys.attention_pairs(4, 4, causal=True, window=2) == 1 + 2 + 2 + 2
    flops, nbytes = ys.flash_attention_work(1, 4, 4, 2, 1, 8, True, 2)
    assert flops == 4 * 2 * 10 * 8
    assert nbytes == 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1)


def test_model_flops_by_hand():
    # MLP [3, 2, 2], batch 1, 2 samples, 2 classes, one step
    train = 4 * 2 * (3 * 2 + 2 * 2)
    inputs = 2 * 2 * 2 * (3 * 2)
    scoring = 2 * 2 * 2 * (3 * 2 + 2 * 2)
    assert ys.mlp_chapter_flops([3, 2, 2], 1, 2, 2) == train + inputs + scoring
    cfg = {"num_layers": 2, "d_model": 4, "n_heads": 2, "n_kv": 1,
           "head_dim": 2, "d_ff": 8, "vocab": 100}
    blk = 2 * 3 * (4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8) + 4 * 1 * 2 * 6 * 2
    assert ys.lm_block_flops(cfg, 1, 3) == blk
    blk2 = ys.lm_block_flops(cfg, 2, 3)
    head = 2 * blk + 3 * 2 * 1 * 3 * 4 * 128
    assert ys.lm_chapter_flops(cfg, 1, 3) == 3 * blk2 + 4 * blk2 + head


def test_mnist_like_is_the_programs_bit_for_bit():
    from repro_torch import data

    x, y = traffic.mnist_like(2 ** 31 + 5, 64)
    task = data.mnist_like(seed=2 ** 31 + 5, n_train=64, n_test=1)
    np.testing.assert_array_equal(x, task.x_train)
    np.testing.assert_array_equal(y, task.y_train)


def test_markov_chain_is_the_programs_chain():
    from repro_torch import data

    ours, theirs = traffic.MarkovChain(1000, 7), data.MarkovLM(1000, 7)
    np.testing.assert_array_equal(ours.succ, theirs.succ)
    np.testing.assert_allclose(ours.cum[:, -1], 1.0)
    toks = ours.sample(3, 50, 9)
    assert toks.shape == (3, 50) and toks.min() >= 0 and toks.max() < 1000
    # every step follows the chain's successor table
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            assert b in ours.succ[a]
    np.testing.assert_array_equal(toks, ours.sample(3, 50, 9))


def test_key_rule_draws_the_programs_numbers():
    from repro_torch.core.rng import TorchKey

    ours = keys.Key(2 ** 31 + 3).fold_in(999).split(4)[2].fold_in(5)
    theirs = TorchKey(2 ** 31 + 3).fold_in(999).split(4)[2].fold_in(5)
    torch.testing.assert_close(ours.permutation(50), theirs.permutation(50))
    torch.testing.assert_close(ours.randint((3, 4), 1, 10),
                               theirs.randint((3, 4), 1, 10))
    torch.testing.assert_close(ours.bernoulli((5,), 0.3),
                               theirs.bernoulli((5,), 0.3))
    logits = torch.randn(6, 10)
    torch.testing.assert_close(ours.categorical(logits),
                               theirs.categorical(logits))
