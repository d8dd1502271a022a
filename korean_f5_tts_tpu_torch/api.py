"""Public Python API: load_vocoder and the F5TTS class (counterpart of
korean_f5_tts_tpu/api.py).

Config lookup by model name, vocoder attach, checkpoint load, `infer()` with
seed management and wav/spectrogram export. The model and the vocoder live
on `device`: the card by default, and a missing card raises; the CPU runs
only when the caller names it. `attn_path` (ops/attention.py:ATTN_PATHS)
picks the attention half's kernels, `attn_int8` (ATTN_INT8: None, "qk",
"qkpv") the int8 attention kernel in kernel A's place, `compute_dtype` the
dtype the weights are cast to (None keeps fp32, as the JAX class does), and
`quantize` rewrites the block linears to int8 weights after that cast (the
JAX class reaches the same through its F5_TTS_INT8 environment variable;
here only the argument does). infer() samples at the reference mel's fp32
whatever the weights' dtype, as the JAX sampler keeps cond's dtype: bf16 or
int8 weights are widened once per call (models/cfm.py:weights_at) and every
kernel of every attn_path and attn_int8 runs its fp32 form (4, 5, 6 and 9
on fp32 rows). bf16 weights therefore save memory only at rest: while it
samples, a call holds their fp32 copy beside them, so its peak is above
that of fp32 weights.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch

from korean_f5_tts_tpu_torch.config import model_config_of
from korean_f5_tts_tpu_torch.infer.model import TTSModel, load_model
from korean_f5_tts_tpu_torch.infer.utils_infer import (
    infer_process,
    preprocess_ref_audio_text,
    remove_silence_for_generated_wav,
    save_spectrogram,
    transcribe,
)
from korean_f5_tts_tpu_torch.models.modules import cast_params
from korean_f5_tts_tpu_torch.models.vocos import Vocos, VocosConfig, init_vocos
from korean_f5_tts_tpu_torch.ops.attention import check_attn_int8, check_attn_path
from korean_f5_tts_tpu_torch.train.checkpoint import params_from_jax
from korean_f5_tts_tpu_torch.utils.audio import save_wav


def load_vocoder(vocoder_name: str = "vocos", is_local: bool = False, local_path: str = "",
                 seed: int = 0, device="cuda", dtype: torch.dtype | None = None) -> Vocos:
    """The vocoder, a callable mel [b, d, n] -> wav [b, nw] that also exposes
    .params and .vcfg so that sampling can decode in the same call.

    With a local converted checkpoint (a flat .npz of the JAX package's
    layout) its weights are used; otherwise seeded random ones (for smoke
    runs: nothing is downloaded).
    """
    if vocoder_name != "vocos":
        raise NotImplementedError(
            "bigvgan vocoder requires external weights; vocos is the default")
    cfg = VocosConfig()
    if is_local and local_path and os.path.exists(local_path):
        params = params_from_jax(dict(np.load(local_path, allow_pickle=False)), device=device)
    else:
        params = init_vocos(cfg, seed=seed, device=device)
    if dtype is not None:
        params = cast_params(params, dtype)
    return Vocos(params, cfg)


class F5TTS:
    def __init__(
        self,
        model: str = "F5TTS_v1_Base",
        ckpt_file: str = "",
        vocab_file: str = "",
        ode_method: str = "euler",
        use_ema: bool = True,
        vocoder_local_path: str | None = None,
        device: str = "cuda",
        tokenizer: str | None = None,
        use_skip_tc: bool = False,
        use_n2gk_plus: bool = True,
        tokenizer_version: str = "new",
        compute_dtype: torch.dtype | None = None,
        attn_path: str = "default",
        attn_int8: str | None = None,
        seed: int = 0,
        quantize: bool = False,
    ):
        model_cfg = model_config_of(model)
        if ode_method != "euler":
            raise ValueError("euler is the supported ODE method")
        self.mel_spec_type = model_cfg.mel.mel_spec_type
        self.target_sample_rate = model_cfg.mel.target_sample_rate
        self.device = device
        self.attn_path = check_attn_path(attn_path)
        self.attn_int8 = check_attn_int8(attn_int8, attn_path)
        self.seed = None

        self.vocoder = load_vocoder(self.mel_spec_type, vocoder_local_path is not None,
                                    vocoder_local_path or "", device=device,
                                    dtype=compute_dtype)
        self.ema_model: TTSModel = load_model(
            model_cfg,
            ckpt_path=ckpt_file or None,
            vocab_file=vocab_file or None,
            use_ema=use_ema,
            tokenizer=tokenizer,
            use_skip_tc=use_skip_tc,
            use_n2gk_plus=use_n2gk_plus,
            tokenizer_version=tokenizer_version,
            dtype=compute_dtype,
            seed=seed,
            device=device,
            quantize=quantize,
        )

    def transcribe(self, ref_audio, language=None):
        return transcribe(ref_audio, language)

    def export_wav(self, wav, file_wave, remove_silence: bool = False):
        save_wav(file_wave, wav, self.target_sample_rate)
        if remove_silence:
            remove_silence_for_generated_wav(file_wave)

    def export_spectrogram(self, spec, file_spec):
        save_spectrogram(spec, file_spec)

    def infer(
        self,
        ref_file: str,
        ref_text: str,
        gen_text: str,
        show_info=print,
        progress=None,
        target_rms: float = 0.1,
        cross_fade_duration: float = 0.15,
        sway_sampling_coef: float = -1.0,
        cfg_strength: float = 2.0,
        nfe_step: int = 32,
        speed: float = 1.0,
        fix_duration: float | None = None,
        remove_silence: bool = False,
        file_wave: str | None = None,
        file_spec: str | None = None,
        seed: int | None = None,
    ):
        if seed is None:
            seed = random.randint(0, sys.maxsize) % (2**31)
        self.seed = seed

        ref_audio, ref_text = preprocess_ref_audio_text(ref_file, ref_text)
        wav, sr, spec = infer_process(
            ref_audio, ref_text, gen_text, self.ema_model, self.vocoder,
            self.mel_spec_type, show_info=show_info, progress=progress,
            target_rms=target_rms, cross_fade_duration=cross_fade_duration,
            nfe_step=nfe_step, cfg_strength=cfg_strength,
            sway_sampling_coef=sway_sampling_coef, speed=speed,
            fix_duration=fix_duration, seed=seed, attn_path=self.attn_path,
            attn_int8=self.attn_int8,
        )
        if file_wave is not None:
            self.export_wav(wav, file_wave, remove_silence)
        if file_spec is not None:
            self.export_spectrogram(spec, file_spec)
        return wav, sr, spec
