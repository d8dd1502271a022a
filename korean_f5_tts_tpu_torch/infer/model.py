"""TTSModel and load_model (counterpart of korean_f5_tts_tpu/infer/model.py).

A model bundle is the backbone's parameter tree (DiT, UNetT or MMDiT) on one
device, its config, the mel config and the tokenizer settings. load_model
reads a checkpoint (a JAX .npz, or a reference torch .pt / .safetensors
through utils/torch_ckpt.py) through load_checkpoint_into_pytree and the
converter, or draws seeded random weights through _INIT_FNS. As in the JAX
package, an MMDiT has no torch-checkpoint converter route: its .pt raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from korean_f5_tts_tpu_torch.config import BACKBONE_CONFIGS, ModelConfig, backbone_of
from korean_f5_tts_tpu_torch.models.dit import init_dit
from korean_f5_tts_tpu_torch.models.mmdit import init_mmdit
from korean_f5_tts_tpu_torch.models.unett import init_unett
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.quant import quantize_params
from korean_f5_tts_tpu_torch.ops.mel import MelConfig, log_mel_prepadded, log_mel_spectrogram
from korean_f5_tts_tpu_torch.text.vocab import load_vocab_file
from korean_f5_tts_tpu_torch.train.checkpoint import (
    flatten_tree,
    load_npz_params,
    params_from_jax,
    unflatten_tree,
)
from korean_f5_tts_tpu_torch.utils import torch_ckpt
from korean_f5_tts_tpu_torch.utils.misc import require_device


@dataclasses.dataclass
class TTSModel:
    params: Any
    arch: Any  # DiTConfig, UNetTConfig or MMDiTConfig
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

    def mel_of_wav(self, wav: np.ndarray) -> np.ndarray:
        """[n] waveform -> [n_frames, n_mels] fp32 log-mel on the host,
        computed on the model's device."""
        wav_t = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        with torch.inference_mode():
            return log_mel_spectrogram(wav_t, self.mel)[0].T.cpu().numpy()

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


_INIT_FNS = {"DiT": init_dit, "UNetT": init_unett, "MMDiT": init_mmdit}


def load_checkpoint_into_pytree(ckpt_path: str, arch, backbone: str | None = None,
                                use_ema: bool = True) -> dict:
    """A checkpoint file -> the JAX package's parameter tree (numpy, JAX
    layouts), as infer/model.py:94-129 does; params_from_jax carries it to
    the port's tensors.

      - .npz: the JAX package's flat dump (train/checkpoint.py), its
        "ema_params/" subtree when asked for and present, else "params/";
      - .pt / .safetensors: a reference checkpoint, unwrapped from
        ema_model_state_dict / model_state_dict, EMA prefix stripped, LoRA
        pairs merged, then converted (q/k columns already half-split): DiT
        and UNetT; an MMDiT raises ValueError, as infer/model.py:129 does.
    backbone None takes the arch config's own.
    """
    if ckpt_path.endswith(".npz"):
        return unflatten_tree(load_npz_params(ckpt_path, use_ema=use_ema))
    backbone = backbone or backbone_of(arch)
    if backbone not in ("DiT", "UNetT"):
        raise ValueError(f"torch conversion not implemented for backbone {backbone}")
    sd = torch_ckpt.strip_ema_prefix(torch_ckpt.load_torch_checkpoint(ckpt_path))
    if any("lora_" in k for k in sd):
        sd = torch_ckpt.merge_lora(sd)
    if backbone == "UNetT":
        return torch_ckpt.convert_unett_state_dict(sd, arch.heads, arch.dim_head, arch.depth,
                                                   arch.conv_layers, arch.skip_connect_type)
    return torch_ckpt.convert_dit_state_dict(sd, arch.heads, arch.dim_head, arch.depth,
                                             arch.conv_layers)


def load_model(model_cfg: ModelConfig, ckpt_path: str | None = None,
               vocab_file: str | None = None, use_ema: bool = True,
               tokenizer: str | None = None, use_skip_tc: bool = False,
               use_n2gk_plus: bool = True, tokenizer_version: str = "new",
               dtype: torch.dtype | None = None, seed: int = 0,
               device="cuda", quantize: bool = False) -> TTSModel:
    """Ready-to-infer TTSModel on `device` (the card unless the caller names
    the CPU; no card raises): the config's backbone (DiT, UNetT or MMDiT)
    from a checkpoint (ckpt_path: a JAX .npz or a reference .pt /
    .safetensors, load_checkpoint_into_pytree) or seeded random init
    (_INIT_FNS). A vocab file sets
    text_num_embeds = vocab size + 1, as in the JAX package.

    quantize=True rewrites the block linears to int8 weights
    (models/quant.py: DEFAULT_QUANT_PATTERNS) after the dtype cast, as
    infer/model.py:170-184 does; the sampler then takes the int8 kernels.
    Only this argument picks the int8 path (no environment variable)."""
    device = require_device(device)
    vocab_char_map = None
    arch = model_cfg.arch
    if type(arch) is not BACKBONE_CONFIGS[model_cfg.backbone]:
        raise ValueError(f"backbone {model_cfg.backbone!r} with an arch of type "
                         f"{type(arch).__name__}")
    if vocab_file is not None and os.path.exists(vocab_file):
        vocab_char_map = load_vocab_file(vocab_file)
        arch = dataclasses.replace(arch, text_num_embeds=len(vocab_char_map) + 1)
    if ckpt_path:
        tree = load_checkpoint_into_pytree(ckpt_path, arch, model_cfg.backbone,
                                           use_ema=use_ema)
        params = params_from_jax(flatten_tree(tree), device=device)
    else:
        params = _INIT_FNS[model_cfg.backbone](arch, seed=seed, device=device)
    if dtype is not None:
        params = cast_params(params, dtype)
    if quantize:
        params = quantize_params(params)
    return TTSModel(params=params, arch=arch, mel=model_cfg.mel,
                    vocab_char_map=vocab_char_map, device=device,
                    tokenizer_type=tokenizer or model_cfg.tokenizer,
                    use_skip_tc=use_skip_tc, use_n2gk_plus=use_n2gk_plus,
                    tokenizer_legacy=(tokenizer_version == "legacy"))
