"""qwen3-moe-235b-a22b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B family].

94 layers, d_model=4096, 64 heads (GQA kv=4, head_dim=128), expert
d_ff=1536, vocab=151936, MoE 128e top-8, qk-norm.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    num_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    groups=((("attn",), 94),),
    moe=MoEConfig(num_experts=128, top_k=8, expert_ff=1536,
                  capacity_factor=1.25),
    source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
))
