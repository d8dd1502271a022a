"""Model configuration dataclasses (counterpart of korean_f5_tts_tpu/config.py).

The JAX package's config module imports its mel ops and so jax; the port
keeps its own copies of DiTConfig, CFMConfig and the DiT presets. Field
names and defaults match the JAX package's.
"""

from __future__ import annotations

import dataclasses

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
    # backward pass ("dots" is ROADMAP.md queue 1 item 10, not ported)
    remat_policy: str = "full"

    @property
    def text_dim_(self) -> int:
        return self.text_dim if self.text_dim is not None else self.mel_dim


@dataclasses.dataclass(frozen=True)
class CFMConfig:
    sigma: float = 0.0
    audio_drop_prob: float = 0.3
    cond_drop_prob: float = 0.2
    frac_lengths_mask: tuple[float, float] = (0.7, 1.0)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "F5TTS_v1_Base"
    arch: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    tokenizer: str = "pinyin"


# the DiT presets of the JAX package's model zoo (config.py:142-157; its UNetT
# presets E2TTS_* wait for their backbone, ROADMAP.md queue 1 item 11)
PRESETS: dict[str, dict] = {
    "F5TTS_v1_Base": dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                          text_mask_padding=True, conv_layers=4, pe_attn_head=None),
    "F5TTS_Base": dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                       text_mask_padding=False, conv_layers=4, pe_attn_head=1),
    "F5TTS_Small": dict(dim=768, depth=18, heads=12, ff_mult=2, text_dim=512,
                        text_mask_padding=False, conv_layers=4, pe_attn_head=1),
}


def _filter_kwargs(cls, d: dict) -> dict:
    """The keys of d that are fields of cls: the arch yamls carry
    runtime-only keys (attn_backend etc.)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def preset_model_config(name: str, **overrides) -> ModelConfig:
    """A preset's ModelConfig; overrides["arch"] updates its DiT fields."""
    arch_kwargs = dict(PRESETS[name])
    arch_kwargs.update(overrides.pop("arch", {}))
    return ModelConfig(name=name, arch=DiTConfig(**_filter_kwargs(DiTConfig, arch_kwargs)),
                       **overrides)


def model_config_from_dict(cfg: dict) -> ModelConfig:
    """A ModelConfig from a config dict of the yaml schema (its model:
    section), config.py:116-130. Only the DiT backbone is ported."""
    m = cfg.get("model", cfg)
    backbone = m.get("backbone", "DiT")
    if backbone != "DiT":
        raise NotImplementedError(f"backbone {backbone!r} is not ported (DiT only)")
    return ModelConfig(name=m.get("name", "F5TTS_v1_Base"),
                       arch=DiTConfig(**_filter_kwargs(DiTConfig, m.get("arch", {}))),
                       mel=MelConfig(**_filter_kwargs(MelConfig, m.get("mel_spec", {}))),
                       tokenizer=m.get("tokenizer", "pinyin"))


def load_model_config(path: str) -> ModelConfig:
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return model_config_from_dict(yaml.safe_load(f))
