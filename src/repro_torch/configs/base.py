"""Model configuration of the port's LM path (own copy of the parts of
``repro.configs.base`` that the port runs).

Every architecture is a ``ModelConfig``. A config is purely
declarative; ``repro_torch.models`` interprets it. Layers are described
by *groups*: ``(pattern, repeat)``, where ``pattern`` is a tuple of
block kinds whose parameters are stacked on a leading ``repeat`` axis,
as in the reference, so its parameter tree converts one to one.

Only the configs whose blocks the port can run are registered
(``qwen2-0.5b``: ``attn``; ``mamba2-780m``: ``mamba2``); the others
wait for their block kinds (``ROADMAP.md`` §1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


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
    LM trainers read. ``moe`` and ``enc_dec`` are kept so that a config
    that sets them is refused by name (``NotImplementedError``); the
    RG-LRU, encoder and vision fields wait for their slices."""
    name: str
    arch_type: str                       # dense | ssm
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
    moe: Optional[object] = None         # MoE blocks: not ported yet
    ssm: Optional[SSMConfig] = None
    ff: FFConfig = dataclasses.field(default_factory=FFConfig)
    enc_dec: bool = False                # encoder-decoder: not ported yet
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
        assert self.layers_in_groups() == self.num_layers, (
            self.name, self.layers_in_groups(), self.num_layers)

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
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=16, head_dim=32,
                                      chunk=32)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=nl, d_model=d_model,
            n_heads=n_heads, n_kv=n_kv, d_ff=2 * d_model,
            vocab=min(self.vocab, 512), head_dim=0, groups=groups,
            window=min(self.window, 64) if self.window else None,
            ssm=ssm, dtype="float32")


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
                       f"{', '.join(list_configs())} (the reference's "
                       f"other configs wait for their block kinds, "
                       f"ROADMAP.md §1)") from None


def list_configs():
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all():
    from repro_torch.configs import mamba2_780m, qwen2_0_5b  # noqa: F401
