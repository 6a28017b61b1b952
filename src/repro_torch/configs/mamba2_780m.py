"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48 blocks, d_model=1536, attention-free, no MLP (d_ff=0), vocab=50280,
ssm_state=128. d_inner = 2*d_model = 3072, head_dim = 64 -> 48 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    n_heads=48,          # SSD heads (d_inner / head_dim)
    n_kv=48,
    d_ff=0,              # attn-free Mamba2: no interleaved MLP
    vocab=50280,
    groups=((("mamba2",), 48),),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2, SSD)",
))
