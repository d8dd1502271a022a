"""Model configuration dataclasses (counterpart of korean_f5_tts_tpu/config.py).

The JAX package's config module imports its mel ops and so jax; the port
keeps its own copies of DiTConfig and the DiT presets. Field names and
defaults match the JAX package's inference fields.
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

    @property
    def text_dim_(self) -> int:
        return self.text_dim if self.text_dim is not None else self.mel_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "F5TTS_v1_Base"
    arch: DiTConfig = dataclasses.field(default_factory=DiTConfig)
    mel: MelConfig = dataclasses.field(default_factory=MelConfig)
    tokenizer: str = "pinyin"


# the DiT presets of the JAX package's model zoo (config.py:142-152)
PRESETS: dict[str, dict] = {
    "F5TTS_v1_Base": dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                          text_mask_padding=True, conv_layers=4, pe_attn_head=None),
    "F5TTS_Base": dict(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
                       text_mask_padding=False, conv_layers=4, pe_attn_head=1),
}


def preset_model_config(name: str) -> ModelConfig:
    return ModelConfig(name=name, arch=DiTConfig(**PRESETS[name]))
