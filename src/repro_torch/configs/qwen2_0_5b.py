"""qwen2-0.5b — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    groups=((("attn",), 24),),
    source="arXiv:2407.10671 (Qwen2)",
))
