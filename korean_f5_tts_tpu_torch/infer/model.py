"""TTSModel and load_model (counterpart of korean_f5_tts_tpu/infer/model.py).

A model bundle is the DiT parameter tree on one device, its config, the mel
config and the tokenizer settings. load_model reads a JAX .npz checkpoint
through the converter or draws seeded random weights.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from korean_f5_tts_tpu.text.vocab import load_vocab_file
from korean_f5_tts_tpu_torch.config import DiTConfig, ModelConfig
from korean_f5_tts_tpu_torch.models.dit import init_dit
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_prepadded
from korean_f5_tts_tpu_torch.train.checkpoint import load_npz_params, params_from_jax


@dataclasses.dataclass
class TTSModel:
    params: Any
    arch: DiTConfig
    mel: MelConfig
    vocab_char_map: dict[str, int] | None
    device: torch.device
    tokenizer_type: str = "custom"
    use_skip_tc: bool = False
    use_n2gk_plus: bool = True
    tokenizer_legacy: bool = False

    # serving reference-mel frame buckets: references are capped at 12 s (1126
    # frames at 24 kHz / hop 256), so three wav-length buckets bound the
    # upload padding at ~2x
    REF_FRAME_BUCKETS = (384, 768, 1152)

    def mel_of_wav_device(self, wav: np.ndarray) -> tuple[torch.Tensor, int]:
        """[n] waveform -> ([1, REF_FRAME_BUCKETS[-1], n_mels] fp32 mel on the
        model's device, n_frames). The variant's reflect padding runs on the
        host; rows >= n_frames are garbage and must be masked by the consumer
        (serve_sample masks cond rows >= lens)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        cfg = self.mel
        hop, n_fft = cfg.hop_length, cfg.n_fft
        pad = n_fft // 2 if cfg.mel_spec_type == "vocos" else (n_fft - hop) // 2
        out_frames = self.REF_FRAME_BUCKETS[-1]
        max_nw = (out_frames - 1) * hop + n_fft - 2 * pad
        if wav.size > max_nw:
            raise ValueError(
                f"mel_of_wav_device: waveform of {wav.size} samples exceeds the largest "
                f"serving ref bucket ({max_nw} samples); clip the reference first")
        if wav.size <= pad:
            # reflect padding needs more than `pad` samples
            wav = np.pad(wav, (0, pad + 1 - wav.size))
        x = np.pad(wav, (pad, pad), mode="reflect")
        n_frames = (x.size - n_fft) // hop + 1
        f_b = next(f for f in self.REF_FRAME_BUCKETS if f >= n_frames)
        x = np.pad(x, (0, (f_b - 1) * hop + n_fft - x.size))
        wav_t = torch.from_numpy(x[None]).to(self.device)
        with torch.inference_mode():
            return log_mel_prepadded(wav_t, cfg, out_frames), int(n_frames)


def load_model(model_cfg: ModelConfig, ckpt_path: str | None = None,
               vocab_file: str | None = None, use_ema: bool = True,
               tokenizer: str | None = None, use_skip_tc: bool = False,
               use_n2gk_plus: bool = True, tokenizer_version: str = "new",
               dtype: torch.dtype | None = None, seed: int = 0,
               device="cpu") -> TTSModel:
    """Ready-to-infer TTSModel on `device`: DiT from a JAX .npz checkpoint
    (ckpt_path) or seeded random init. A vocab file sets
    text_num_embeds = vocab size + 1, as in the JAX package."""
    device = torch.device(device)
    vocab_char_map = None
    arch = model_cfg.arch
    if vocab_file is not None and os.path.exists(vocab_file):
        vocab_char_map = load_vocab_file(vocab_file)
        arch = dataclasses.replace(arch, text_num_embeds=len(vocab_char_map) + 1)
    if ckpt_path:
        if not ckpt_path.endswith(".npz"):
            raise ValueError("the port loads JAX .npz checkpoints only (torch "
                             "checkpoint conversion is not ported yet)")
        params = params_from_jax(load_npz_params(ckpt_path, use_ema=use_ema), device=device)
    else:
        params = init_dit(arch, seed=seed, device=device)
    if dtype is not None:
        params = cast_params(params, dtype)
    return TTSModel(params=params, arch=arch, mel=model_cfg.mel,
                    vocab_char_map=vocab_char_map, device=device,
                    tokenizer_type=tokenizer or model_cfg.tokenizer,
                    use_skip_tc=use_skip_tc, use_n2gk_plus=use_n2gk_plus,
                    tokenizer_legacy=(tokenizer_version == "legacy"))
