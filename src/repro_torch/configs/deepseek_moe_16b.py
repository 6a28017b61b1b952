"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed, top-6
[arXiv:2401.06066]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=102400,
    groups=((("attn",), 28),),
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  num_shared=2, shared_ff=2816, capacity_factor=1.25),
    source="arXiv:2401.06066 (DeepSeekMoE)",
))
