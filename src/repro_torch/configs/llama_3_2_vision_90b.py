"""llama-3.2-vision-90b — cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled to 90B].

100 layers = 20 x (4 self-attn + 1 cross-attn). d_model=8192, 64 heads
(GQA kv=8, head_dim=128), d_ff=28672, vocab=128256. The vision frontend
(ViT encoder + projector) is a stub: ``launch.serve.lm_decode`` supplies
projected patch embeddings (batch, vision_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=500000.0,
    groups=((("attn", "attn", "attn", "attn", "cross_attn"), 20),),
    vision_tokens=1600,
    vision_dim=8192,
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scale per assignment)",
))
