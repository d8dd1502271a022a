"""Model configuration dataclasses (counterpart of korean_f5_tts_tpu/config.py).

The JAX package's config module imports its mel ops and so jax; the port
keeps its own copies of the three backbones' configs (DiTConfig, UNetTConfig,
MMDiTConfig), CFMConfig and the presets. Field names and defaults match the
JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from korean_f5_tts_tpu_torch.ops.mel import MelConfig


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    dropout: float = 0.1
    ff_mult: int = 2
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int | None = 512
    text_mask_padding: bool = True
    text_embedding_average_upsampling: bool = False
    qk_norm: str | None = None
    conv_layers: int = 4
    conv_mult: int = 2
    pe_attn_head: int | None = None
    attn_mask_enabled: bool = False
    long_skip_connection: bool = False
    checkpoint_activations: bool = False
    # remat under checkpoint_activations: "full" recomputes each block in the
    # backward pass, "dots" only its elementwise ops (models/dit.py:dit_backbone)
    remat_policy: str = "full"

    @property
    def text_dim_(self) -> int:
        return self.text_dim if self.text_dim is not None else self.mel_dim


@dataclasses.dataclass(frozen=True)
class UNetTConfig:
    dim: int = 1024
    depth: int = 24
    heads: int = 16
    dim_head: int = 64
    dropout: float = 0.1
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_dim: int | None = None
    text_mask_padding: bool = True
    qk_norm: str | None = None
    conv_layers: int = 0
    conv_mult: int = 2
    pe_attn_head: int | None = None
    attn_mask_enabled: bool = False
    skip_connect_type: str = "concat"  # "none" | "add" | "concat"
    checkpoint_activations: bool = False

    @property
    def text_dim_(self) -> int:
        return self.text_dim if self.text_dim is not None else self.mel_dim


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    dropout: float = 0.1
    ff_mult: int = 4
    mel_dim: int = 100
    text_num_embeds: int = 256
    text_mask_padding: bool = True
    qk_norm: str | None = None
    checkpoint_activations: bool = False


BACKBONE_CONFIGS = {"DiT": DiTConfig, "UNetT": UNetTConfig, "MMDiT": MMDiTConfig}


def backbone_of(arch) -> str:
    """The backbone name of an arch config ("DiT", "UNetT" or "MMDiT")."""
    for name, cls in BACKBONE_CONFIGS.items():
        if type(arch) is cls:
            return name
    raise TypeError(f"unsupported backbone config: {type(arch)}")


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    sigma: float = 0.0
    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "F5TTS_v1_Base"
    backbone: str = "DiT"
    arch: Any = dataclasses.field(default_factory=DiTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    tokenizer: str = "pinyin"


# the presets of the JAX package's model zoo (config.py:142-167)
PRESETS: dict[str, dict] = {
    "F5TTS_v1_Base": dict(
        backbone="DiT",
        arch=dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                  text_mask_padding=True, conv_layers=4, pe_attn_head=None),
    ),
    "F5TTS_Base": dict(
        backbone="DiT",
        arch=dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                  text_mask_padding=False, conv_layers=4, pe_attn_head=1),
    ),
    "F5TTS_Small": dict(
        backbone="DiT",
        arch=dict(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
                  text_mask_padding=False, conv_layers=4, pe_attn_head=1),
    ),
    "E2TTS_Base": dict(
        backbone="UNetT",
        arch=dict(dim=1024, depth=24, heads=16, ff_mult=4, text_mask_padding=False),
    ),
    "E2TTS_Small": dict(
        backbone="UNetT",
        arch=dict(dim=768, depth=20, heads=12, ff_mult=4, text_mask_padding=False),
    ),
}


def _filter_kwargs(cls, d: dict) -> dict:
    """The keys of d that are fields of cls: the arch yamls carry
    runtime-only keys (attn_backend etc.)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def preset_model_config(name: str, **overrides) -> ModelConfig:
    """A preset's ModelConfig; overrides["arch"] updates its arch fields."""
    p = PRESETS[name]
    arch_cls = BACKBONE_CONFIGS[p["backbone"]]
    arch_kwargs = dict(p["arch"])
    arch_kwargs.update(overrides.pop("arch", {}))
    return ModelConfig(name=name, backbone=p["backbone"],
                       arch=arch_cls(**_filter_kwargs(arch_cls, arch_kwargs)), **overrides)


def model_config_from_dict(cfg: dict) -> ModelConfig:
    """A ModelConfig from a config dict of the yaml schema (its model:
    section), config.py:116-130, for any of the three backbones."""
    m = cfg.get("model", cfg)
    backbone = m.get("backbone", "DiT")
    arch_cls = BACKBONE_CONFIGS[backbone]
    return ModelConfig(name=m.get("name", "F5TTS_v1_Base"), backbone=backbone,
                       arch=arch_cls(**_filter_kwargs(arch_cls, m.get("arch", {}))),
                       mel=MelConfig(**_filter_kwargs(MelConfig, m.get("mel_spec", {}))),
                       tokenizer=m.get("tokenizer", "pinyin"))


def load_model_config(path: str) -> ModelConfig:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return model_config_from_dict(yaml.safe_load(f))


def model_config_of(model: str) -> ModelConfig:
    """A preset's ModelConfig by name, or a model config yaml by path."""
    import os

    if model in PRESETS:
        return preset_model_config(model)
    if os.path.exists(model):
        return load_model_config(model)
    raise ValueError(f"unknown model {model}; presets: {sorted(PRESETS)}")
