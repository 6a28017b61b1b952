"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    window=4096,              # sliding-window attention (mistral-style)
    groups=((("attn",), 24),),
    source="arXiv:2401.16818 (h2o-danube)",
))
