"""qwen3-8b — qk-norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    groups=((("attn",), 36),),
    source="hf:Qwen/Qwen3-8B",
))
