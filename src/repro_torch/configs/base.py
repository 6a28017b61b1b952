"""Model configuration of the port's LM path (own copy of the parts of
``repro.configs.base`` that the port runs).

Every architecture is a ``ModelConfig``. A config is purely
declarative; ``repro_torch.models`` interprets it. Layers are described
by *groups*: ``(pattern, repeat)``, where ``pattern`` is a tuple of
block kinds whose parameters are stacked on a leading ``repeat`` axis,
as in the reference, so its parameter tree converts one to one.

All ten of the reference's LM configs are registered: ``qwen2-0.5b``,
``tinyllama-1.1b``, ``qwen3-8b`` and ``h2o-danube-3-4b`` (``attn``),
``mamba2-780m`` (``mamba2``), ``recurrentgemma-2b`` (``rglru`` and
``local_attn``), ``deepseek-moe-16b`` and ``qwen3-moe-235b-a22b``
(``attn`` blocks with MoE MLPs), ``seamless-m4t-large-v2`` (a
bidirectional ``attn`` encoder, then ``xdec`` decoder blocks) and
``llama-3.2-vision-90b`` (``attn`` and ``cross_attn`` blocks).

One more has no counterpart in the reference (``port_only``):
``moonlight-16b-a3b``, DeepSeek-V3's block (``mla_dense`` then
``mla_moe``: multi-head latent attention, a dense MLP or the
sigmoid-routed MoE). Its fields live in subclasses
(``MLAModelConfig``, ``SigmoidMoEConfig``), so that the reference's
configs keep the reference's fields, one for one.

The reference's four input shapes (``INPUT_SHAPES``) and the archs that
may run ``long_500k`` (``SUBQUADRATIC``) are copied for the dry run
(``launch.dryrun``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0
    shared_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SigmoidMoEConfig(MoEConfig):
    """DeepSeek-V3's router (arXiv:2412.19437 §2.1.2), with no group
    limit (``n_group`` = ``topk_group`` = 1): sigmoid scores over every
    expert, the top-k of scores plus a correction bias that takes no
    gradient, the chosen scores normalised to sum 1 and scaled by
    ``routed_scale``; the sequence-wise balance loss weighed by
    ``router_aux_weight`` (alpha), and after each grad step the bias
    moved by ``bias_rate`` (gamma) toward an even load. No choice is
    dropped (``capacity_factor`` is not read). The layer holds experts
    ``[expert_offset, expert_offset + experts_held)`` of
    ``num_experts`` (0 held: every one) and computes their part alone."""
    routed_scale: float = 1.0
    bias_rate: float = 0.0
    experts_held: int = 0
    expert_offset: int = 0

    @property
    def held(self) -> int:
        return self.experts_held or self.num_experts


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention with no q LoRA (DeepSeek-V2/V3): q
    from x directly, k and v from a ``kv_lora_rank`` latent under an RMS
    norm, each head's key ``qk_nope_head_dim`` from the latent plus
    ``qk_rope_head_dim`` roped ones shared by every head."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0          # 0 -> d_model
    conv_width: int = 4
    window: int = 2048          # local-attn window used by hybrid attn blocks


@dataclasses.dataclass(frozen=True)
class FFConfig:
    """Forward-Forward training configuration of an LM (the reference's
    ``FFConfig``)."""
    goodness: str = "sumsq"       # sumsq | perf_opt (Performance-Optimized)
    theta: float = 2.0            # goodness threshold
    neg_mode: str = "random"      # adaptive | fixed | random (token corruption)
    peer_norm_weight: float = 0.03


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's ``ModelConfig`` fields that the port's blocks and
    LM trainers read (all but its ``remat``). With ``enc_dec`` the
    leading ``enc_layers`` blocks of ``groups`` form a bidirectional
    encoder over ``enc_seq`` stub frame embeddings and ``num_layers``
    counts the decoder's; ``vision_tokens`` is the stub patch count that
    ``cross_attn`` blocks read."""
    name: str
    arch_type: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    groups: Tuple[Tuple[Tuple[str, ...], int], ...] = ()
    head_dim: int = 0                    # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None         # sliding-window size (attn)
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ff: FFConfig = dataclasses.field(default_factory=FFConfig)
    # encoder-decoder (audio) ---------------------------------------------
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1024                  # stub frontend frame count
    # vlm ------------------------------------------------------------------
    vision_tokens: int = 0               # stub frontend patch count
    vision_dim: int = 0                  # embedding dim delivered by stub
    dtype: str = "bfloat16"
    source: str = ""                     # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows, padded to a multiple of 128 as the reference
        pads them; padded ids never appear in data and ``unembed``
        masks their logits."""
        return -(-self.vocab // 128) * 128

    def layers_in_groups(self) -> int:
        return sum(len(p) * r for p, r in self.groups)

    def validate(self) -> None:
        assert self.layers_in_groups() == (
            self.num_layers + (self.enc_layers if self.enc_dec else 0)
        ), (self.name, self.layers_in_groups(), self.num_layers)

    def reduced(self, d_model: int = 256, layers_hint: int = 2
                ) -> "ModelConfig":
        """A tiny same-family variant for CPU tests, equal field for
        field to the reference's ``reduced()`` of the same config."""
        n_heads = max(2, min(4, self.n_heads))
        n_kv = max(1, min(self.n_kv, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        groups = _reduce_groups(self.groups, layers_hint)
        nl = sum(len(p) * r for p, r in groups)
        enc_l = 0
        if self.enc_dec:
            enc_l = nl // 2
            nl = nl - enc_l
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, expert_ff=2 * d_model,
                num_shared=min(self.moe.num_shared, 1),
                shared_ff=2 * d_model if self.moe.num_shared else 0)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=16, head_dim=32,
                                      chunk=32)
        rglru = None
        if self.rglru is not None:
            rglru = dataclasses.replace(self.rglru, lru_width=d_model,
                                        window=32)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=nl, d_model=d_model,
            n_heads=n_heads, n_kv=n_kv, d_ff=2 * d_model,
            vocab=min(self.vocab, 512), head_dim=0, groups=groups,
            window=min(self.window, 64) if self.window else None,
            moe=moe, ssm=ssm, rglru=rglru, enc_layers=enc_l,
            enc_seq=16, vision_tokens=8 if self.vision_tokens else 0,
            vision_dim=d_model if self.vision_dim else 0,
            dtype="float32")


@dataclasses.dataclass(frozen=True)
class MLAModelConfig(ModelConfig):
    """A ``ModelConfig`` with ``mla`` (``MLAConfig``), read by the
    ``mla_dense`` and ``mla_moe`` blocks; ``d_ff`` is the dense
    block's MLP."""
    mla: Optional[MLAConfig] = None

    def reduced(self, d_model: int = 64, layers_hint: int = 2
                ) -> "MLAModelConfig":
        """A tiny same-family variant for CPU tests: every width cut, a
        value width other than the query's kept, every expert held."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=8, top_k=3, expert_ff=2 * d_model,
                num_shared=min(self.moe.num_shared, 1),
                shared_ff=2 * d_model if self.moe.num_shared else 0,
                experts_held=0, expert_offset=0)
        groups = _reduce_groups(self.groups, layers_hint)
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            num_layers=sum(len(p) * r for p, r in groups), d_model=d_model,
            n_heads=4, n_kv=4, d_ff=2 * d_model, vocab=min(self.vocab, 512),
            head_dim=0, groups=groups, moe=moe, dtype="float32",
            mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16))


def _reduce_groups(groups, layers_hint):
    """Keep one pattern-unit per distinct group, repeat=1."""
    out = []
    seen = set()
    for pattern, _ in groups:
        if pattern in seen:
            continue
        seen.add(pattern)
        out.append((pattern, 1))
    if not out:
        out = [(("attn",), layers_hint)]
    return tuple(out)



# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned four, for the dry run)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k (sub-quadratic sequence mixing).
SUBQUADRATIC = {"mamba2-780m", "recurrentgemma-2b", "h2o-danube-3-4b"}


_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown config {name!r}; the port registers "
                       f"{', '.join(list_configs())}") from None


def list_configs():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def reference_names():
    """The registered configs that the reference has too (every one
    ``port_only`` does not take): what a test pairing port and reference
    iterates."""
    return [n for n in list_configs() if not port_only(get_config(n))]


def port_only(cfg) -> bool:
    """Whether ``cfg`` (a registered config or a variant of one) has no
    counterpart in the reference: the paths mirrored from it (``Dist``,
    the dry run, the pod pipeline, serving) refuse it."""
    return isinstance(cfg, MLAModelConfig)


def load_all():
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b, h2o_danube_3_4b, llama_3_2_vision_90b,
        mamba2_780m, moonlight_16b_a3b, qwen2_0_5b, qwen3_8b,
        qwen3_moe_235b_a22b, recurrentgemma_2b, seamless_m4t_large_v2,
        tinyllama_1_1b)
