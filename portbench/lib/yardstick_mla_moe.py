"""Model operations of one chapter of the MLA + MoE cut (a frozen copy
of nothing in the program: written from the layer equations of
``reference/mla_moe.py``), in the manner of ``yardstick.lm_chapter_flops``:
the work the algorithm needs, none of a schedule's or kernel's extra
work (the chunked route's masked pairs, recomputes, padding).

Per token of a layer's forward: MLA's projections (q, kv_a, kv_b, o),
causal attention over the visible pairs at nope + rope (q k) plus dv (p
v) products a head; the dense layer's gated MLP; an MoE layer's router,
its shared experts whole and its routed experts over the (token, slot)
pairs that land on this card's experts at an even load: k x E_h / E of
them a token. The share is the deployment's, fixed by the
configuration, and read from nothing the program reports; a skewed
router gives the card more pairs than this counts.
"""
from __future__ import annotations

from portbench.lib import yardstick as ys


def layer_flops(cfg, rows, seq, dense):
    """One layer's forward over ``rows`` sequences of ``seq`` tokens."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    rope, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    T = rows * seq
    proj = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv) \
        + H * dv * d
    attn = 2 * rows * H * ys.attention_pairs(seq, seq, True) \
        * (nope + rope + dv)
    if dense:
        mlp = 3 * d * cfg["intermediate_size"]
    else:
        E, E_h, k = (cfg["router_experts"], cfg["n_routed_experts"],
                     cfg["num_experts_per_tok"])
        ff = cfg["moe_intermediate_size"]
        mlp = d * E + 3 * d * ff * cfg["n_shared_experts"] \
            + k * E_h / E * 3 * d * ff
    return 2 * T * (proj + mlp) + attn


def chapter_flops(cfg, batch, seq, steps=1):
    """One chapter of ``pff_lm.train_chapters``: for each block k, its
    ``steps`` grad steps on 2 x batch rows (positives and corruptions),
    a frozen forward through blocks < k and the block's forward and
    backward (3 forwards); then the head task: a frozen forward through
    every block on ``batch`` rows, and the untied head's forward and its
    two backward products over the vocabulary slice."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    dense = cfg["first_k_dense_replace"]
    vp = -(-cfg["vocab_size"] // 128) * 128
    blk = [layer_flops(cfg, 2 * batch, seq, j < dense) for j in range(L)]
    blocks = steps * sum(sum(blk[:k]) + 3 * blk[k] for k in range(L))
    head = sum(layer_flops(cfg, batch, seq, j < dense) for j in range(L)) \
        + 3 * 2 * batch * seq * d * vp
    return blocks + head
