"""moonlight-16b-a3b — DeepSeek-V3's block: MLA, one dense layer, then
a sigmoid-routed fine-grained MoE (64 routed experts, top-6, 2 shared)
[hf:moonshotai/Moonlight-16B-A3B, config.json, model_type deepseek_v3].

27 layers, d_model 2048, 16 heads; MLA with no q LoRA (kv_lora_rank
512, qk_nope 128, qk_rope 64, v 128); layer 0's MLP dense at 11264
(``first_k_dense_replace`` 1), layers 1-26 MoE at 1408 per expert with
2 shared experts (one MLP of 2816); router ``noaux_tc`` with one group,
``norm_topk_prob``, ``routed_scaling_factor`` 2.446; vocabulary 163840
untied; RMSNorm eps 1e-5; RoPE theta 50000, no scaling. The training
balance (gamma 0.001, alpha 1e-4) is DeepSeek-V3's (arXiv:2412.19437
§2.1.2): the published config does not state it. Port only: the
reference has no such config.
"""
from repro_torch.configs.base import (MLAConfig, MLAModelConfig,
                                      SigmoidMoEConfig, register)

CONFIG = register(MLAModelConfig(
    name="moonlight-16b-a3b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=192,
    d_ff=11264,
    vocab=163840,
    rope_theta=50000.0,
    norm_eps=1e-5,
    groups=((("mla_dense",), 1), (("mla_moe",), 26)),
    moe=SigmoidMoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                         num_shared=2, shared_ff=1408,
                         router_aux_weight=1e-4, routed_scale=2.446,
                         bias_rate=1e-3),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="hf:moonshotai/Moonlight-16B-A3B (config.json); "
           "arXiv:2412.19437 (DeepSeek-V3)",
))
