"""tinyllama-1.1b — llama2-architecture small model [arXiv:2401.02385]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    num_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_ff=5632,
    vocab=32000,
    groups=((("attn",), 22),),
    source="arXiv:2401.02385 (TinyLlama)",
))
