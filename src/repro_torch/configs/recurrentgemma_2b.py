"""recurrentgemma-2b — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

26 layers, pattern (rglru, rglru, local_attn) x 8 + (rglru, rglru),
d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680, vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    groups=(
        (("rglru", "rglru", "local_attn"), 8),
        (("rglru", "rglru"), 1),
    ),
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, window=2048),
    act="gelu",
    logit_softcap=30.0,
    tie_embeddings=True,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
))
