"""seamless-m4t-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

24 transformer-backbone layers interpreted as 12 encoder + 12 decoder
(text decoder with cross-attention). d_model=1024, 16 heads (kv=16),
d_ff=8192, vocab=256206. The audio frontend (mel + conv feature
extractor) is a stub: ``launch.serve.lm_decode`` supplies frame
embeddings of shape (batch, enc_seq, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=12,            # decoder layers
    enc_layers=12,            # encoder layers
    enc_dec=True,
    enc_seq=1024,             # audio frames delivered by the stub frontend
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256206,
    groups=(
        (("attn",), 12),      # encoder (bidirectional)
        (("xdec",), 12),      # decoder (self-attn + cross-attn + mlp)
    ),
    act="relu",
    source="arXiv:2308.11596 (SeamlessM4T v2)",
))
