"""Inference pipeline: chunking, ref-audio preprocessing, batch synthesis,
cross-fade stitching.

Capability parity with reference `src/f5_tts/infer/utils_infer.py`:
  - module-level inference defaults (`:62-75`)
  - sentence-aware utf-8-budget `chunk_text` (`:83-110`)
  - ref-audio preprocessing with silence clipping to <=12 s and md5 caching
    (`:367-447`; Whisper ASR fallback is gated — no model weights offline)
  - `infer_process`: dynamic max_chars from ref speed (`:453-498`)
  - `infer_batch_process`: RMS normalisation, tokenizer dispatch, byte-ratio
    duration estimate, sample + vocode, streaming chunks, cross-fade stitch
    (`:504-778`)

The port's counterpart of korean_f5_tts_tpu/infer/utils_infer.py.
Host-side orchestration only; the device work happens inside `cfm_sample`
and the vocoder, on the model's device. Chunks are synthesized one after
another at batch 1, each at its own duration bucket. The vocoder's frame
bucket, the duration and text buckets, `attn_path` and `attn_int8` are arguments, not
environment variables.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np
import torch

from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, list_str_to_tensor, tokenize_text
from korean_f5_tts_tpu_torch.utils import audio as audio_utils

# -- inference defaults (reference utils_infer.py:62-75) ---------------------

target_sample_rate = 24_000
n_mel_channels = 100
hop_length = 256
win_length = 1024
n_fft = 1024
mel_spec_type = "vocos"
target_rms = 0.1
cross_fade_duration = 0.15
ode_method = "euler"
nfe_step = 32
cfg_strength = 2.0
sway_sampling_coef = -1.0
speed = 1.0
fix_duration = None

_ref_audio_cache: dict = {}
_ref_text_cache: dict = {}
_asr_backend = None


def set_asr_backend(fn) -> None:
    """Install a transcription backend `fn(path, language=None) -> text`."""
    global _asr_backend
    _asr_backend = fn


def transcribe(ref_audio: str, language: str | None = None) -> str:
    """ASR of a reference clip (utils_infer.py:161-192 role).

    The reference downloads Whisper-large-v3-turbo; offline builds must
    install a backend via set_asr_backend (e.g. a local Whisper checkpoint
    through transformers).
    """
    if _asr_backend is None:
        raise RuntimeError(
            "no ASR backend installed (offline image has no Whisper weights); "
            "call set_asr_backend(fn) or pass ref_text explicitly"
        )
    return _asr_backend(ref_audio, language)


VOCODER_BUCKET = 256  # frames; _vocode_bucketed pads the mel to a multiple


def vocoder_input(vocoder, mel: np.ndarray, device=None) -> torch.Tensor:
    """The [b, d, n] mel as the vocoder takes it: on its parameters' device
    in their dtype when it exposes .params (models.vocos.Vocos), else fp32 on
    `device` (a plain callable; the model's device, or the CPU when None)."""
    params = getattr(vocoder, "params", None)
    if params is not None:
        ref = params["head"]["w"]
        return torch.as_tensor(mel, device=ref.device).to(ref.dtype)
    return torch.as_tensor(mel, dtype=torch.float32, device=device)


def _vocode_bucketed(vocoder, mel_out: np.ndarray, bucket: int = VOCODER_BUCKET,
                     device=None) -> np.ndarray:
    """Decode [b, d, n] mel with the frame count padded to a `bucket`-frame
    multiple (utils_infer.py:76-107), so the vocoder sees a small set of
    shapes. The wav is sliced back to the exact-length output size.
    The pad frames still sit inside the vocoder's receptive field, so the
    last ~50 frames' samples deviate slightly from an exact-length decode;
    with trained models the tail is trailing silence and the replicate pad
    is inaudible. bucket=0 decodes at exact lengths. `vocoder` is a callable
    mel tensor [b, d, n] -> waveform tensor (models.vocos.Vocos, or any
    callable); vocoder_input says where the mel goes.
    """
    b, d, n = mel_out.shape
    nb = max(bucket, -(-n // bucket) * bucket) if bucket > 0 else n
    if nb != n:
        # replicate the last frame: zeros are LOUD in log-mel space
        # (exp(0)=1) and their conv bleed would contaminate the real tail
        mel_in = np.concatenate(
            [mel_out, np.repeat(mel_out[:, :, -1:], nb - n, axis=2)], axis=2)
    else:
        mel_in = mel_out
    wav = vocoder(vocoder_input(vocoder, mel_in, device)).float().cpu().numpy().reshape(b, -1)
    if nb == n:
        return wav
    # both vocoder families upsample by exactly hop_length samples/frame
    # (ISTFT: (n-1)*hop, BigVGAN: n*hop), so trimming the pad frames'
    # samples recovers the exact-length output size either way
    return wav[:, : wav.shape[-1] - (nb - n) * hop_length]


def chunk_text(text: str, max_chars: int = 135) -> list[str]:
    """Sentence-aware splitting with a utf-8 byte budget (utils_infer.py:83-110)."""
    chunks = []
    current_chunk = ""
    sentences = re.split(r"(?<=[;:,.!?])\s+|(?<=[；：，。！？])", text)
    for sentence in sentences:
        if len(current_chunk.encode("utf-8")) + len(sentence.encode("utf-8")) <= max_chars:
            current_chunk += (
                sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1 else sentence
            )
        else:
            if current_chunk:
                chunks.append(current_chunk.strip())
            current_chunk = (
                sentence + " " if sentence and len(sentence[-1].encode("utf-8")) == 1 else sentence
            )
    if current_chunk:
        chunks.append(current_chunk.strip())
    return chunks


def preprocess_ref_audio_text(
    ref_audio_path: str,
    ref_text: str,
    clip_short: bool = True,
    show_info=print,
) -> tuple[tuple[np.ndarray, int], str]:
    """Clip ref audio to <=12 s at silence boundaries; md5-cache results.

    Parity: utils_infer.py:367-447. Returns ((wav [n], sr), ref_text).
    The Whisper auto-transcription fallback requires downloadable weights and
    is unavailable offline — empty ref_text raises with guidance instead.
    """
    wav, sr = audio_utils.load_wav(ref_audio_path)
    mono = audio_utils.to_mono(wav)

    with open(ref_audio_path, "rb") as f:
        audio_hash = hashlib.md5(f.read()).hexdigest()

    if clip_short:
        if audio_hash in _ref_audio_cache:
            mono, sr = _ref_audio_cache[audio_hash]
        else:
            max_len = 12 * sr
            if len(mono) > max_len:
                # 1. try long-silence (>=1s) split boundaries
                clipped = None
                for min_sil, db in ((1000, -50.0), (100, -40.0)):
                    spans = audio_utils.split_on_silence_spans(
                        mono, sr, min_silence_ms=min_sil, silence_threshold_db=db
                    )
                    acc_end = 0
                    for s, e in spans:
                        if e > max_len and acc_end > 6 * sr:
                            break
                        acc_end = e
                    if 0 < acc_end <= max_len:
                        clipped = mono[:acc_end]
                        break
                mono = clipped if clipped is not None else mono[:max_len]
                show_info("Ref audio clipped to <=12 s at a silence boundary.")
            mono = audio_utils.remove_silence_edges(mono, sr)
            # keep a short trailing pause like the reference (+50 ms headroom)
            mono = np.concatenate([mono, np.zeros(int(0.05 * sr), np.float32)])
            _ref_audio_cache[audio_hash] = (mono, sr)

    if not ref_text.strip():
        if audio_hash in _ref_text_cache:
            ref_text = _ref_text_cache[audio_hash]
        elif _asr_backend is not None:
            ref_text = transcribe(ref_audio_path)
            show_info("Using ASR transcription as ref_text.")
        else:
            raise ValueError(
                "ref_text is empty and no ASR backend is installed "
                "(set_asr_backend); pass the reference transcription explicitly."
            )
    _ref_text_cache[audio_hash] = ref_text

    # ensure trailing punctuation + space (utils_infer.py:437-445)
    if not ref_text.endswith(". ") and not ref_text.endswith("。"):
        if ref_text.endswith("."):
            ref_text += " "
        else:
            ref_text += ". "
    return (mono, sr), ref_text


def infer_process(
    ref_audio: tuple[np.ndarray, int] | str,
    ref_text: str,
    gen_text: str,
    model_obj,
    vocoder=None,
    mel_spec_type: str = mel_spec_type,
    show_info=print,
    progress=None,
    target_rms: float = target_rms,
    cross_fade_duration: float = cross_fade_duration,
    nfe_step: int = nfe_step,
    cfg_strength: float = cfg_strength,
    sway_sampling_coef: float = sway_sampling_coef,
    speed: float = speed,
    fix_duration: float | None = fix_duration,
    seed: int | None = None,
    vocoder_fused: tuple | None = None,
    duration_bucket: int | None = None,
    vocoder_bucket: int = VOCODER_BUCKET,
    kernels: bool = True,
    attn_path: str = "default",
    attn_int8: str | None = None,
):
    """Chunk long text and synthesize (utils_infer.py:453-498)."""
    if isinstance(ref_audio, str):
        wav, sr = audio_utils.load_wav(ref_audio)
        wav = audio_utils.to_mono(wav)
    else:
        wav, sr = ref_audio
        wav = audio_utils.to_mono(np.asarray(wav))
    ref_seconds = len(wav) / sr
    max_chars = int(
        len(ref_text.encode("utf-8")) / ref_seconds * (22 - ref_seconds) * speed
    )
    gen_text_batches = chunk_text(gen_text, max_chars=max_chars)
    show_info(f"Generating audio in {len(gen_text_batches)} batches...")
    return next(
        infer_batch_process(
            (wav, sr), ref_text, gen_text_batches, model_obj, vocoder,
            mel_spec_type=mel_spec_type, progress=progress, target_rms=target_rms,
            cross_fade_duration=cross_fade_duration, nfe_step=nfe_step,
            cfg_strength=cfg_strength, sway_sampling_coef=sway_sampling_coef,
            speed=speed, fix_duration=fix_duration, seed=seed,
            vocoder_fused=vocoder_fused, duration_bucket=duration_bucket,
            vocoder_bucket=vocoder_bucket, kernels=kernels, attn_path=attn_path,
            attn_int8=attn_int8,
        )
    )


def infer_batch_process(
    ref_audio: tuple[np.ndarray, int],
    ref_text: str,
    gen_text_batches: list[str],
    model_obj,
    vocoder=None,
    mel_spec_type: str = "vocos",
    progress=None,
    target_rms: float = 0.1,
    cross_fade_duration: float = 0.15,
    nfe_step: int = 32,
    cfg_strength: float = 2.0,
    sway_sampling_coef: float = -1.0,
    speed: float = 1.0,
    fix_duration: float | None = None,
    streaming: bool = False,
    chunk_size: int = 2048,
    seed: int | None = None,
    vocoder_fused: tuple | None = None,  # (voc_params, VocosConfig): one call
    duration_bucket: int | None = None,
    vocoder_bucket: int = VOCODER_BUCKET,
    kernels: bool = True,
    attn_path: str = "default",
    attn_int8: str | None = None,
):
    """Per-chunk synthesis + cross-fade stitch (utils_infer.py:504-778).

    model_obj is a `korean_f5_tts_tpu_torch.infer.model.TTSModel`.
    """
    wav, sr = ref_audio
    wav = audio_utils.to_mono(np.asarray(wav, dtype=np.float32))
    rms_val = audio_utils.rms(wav)
    if rms_val < target_rms and rms_val > 0:
        wav = wav * (target_rms / rms_val)
    if sr != target_sample_rate:
        wav = audio_utils.resample(wav, sr, target_sample_rate)

    if len(ref_text[-1].encode("utf-8")) == 1:
        ref_text = ref_text + " "

    ref_mel = model_obj.mel_of_wav(wav)  # [n_frames, n_mels]
    ref_audio_len = ref_mel.shape[0]

    def process_batch(gen_text: str):
        local_speed = speed
        if len(gen_text.encode("utf-8")) < 10:
            local_speed = 0.3

        text_list = [ref_text + gen_text]
        final_text_list = tokenize_text(
            text_list,
            tokenizer_type=model_obj.tokenizer_type,
            vocab=model_obj.vocab_char_map,
            use_n2gk_plus=model_obj.use_n2gk_plus,
            use_skip_tc=model_obj.use_skip_tc,
            legacy=model_obj.tokenizer_legacy,
        )

        if fix_duration is not None:
            duration = int(fix_duration * target_sample_rate / hop_length)
        else:
            ref_text_len = len(ref_text.encode("utf-8"))
            gen_text_len = len(gen_text.encode("utf-8"))
            duration = ref_audio_len + int(
                ref_audio_len / ref_text_len * gen_text_len / local_speed
            )

        if model_obj.vocab_char_map is not None:
            text_ids = list_str_to_idx(final_text_list, model_obj.vocab_char_map)
        else:
            # no vocab: utf-8 byte tokenizer fallback (cfm.py:119-124)
            text_ids = list_str_to_tensor(["".join(t) for t in final_text_list])
        generated, wav_full = cfm_sample(
            model_obj.params, model_obj.arch,
            ref_mel[None], text_ids, duration,
            steps=nfe_step, cfg_strength=cfg_strength,
            sway_sampling_coef=sway_sampling_coef, seed=seed,
            vocoder_fused=vocoder_fused, duration_bucket=duration_bucket,
            kernels=kernels, attn_path=attn_path, attn_int8=attn_int8,
        )
        generated = generated[:, ref_audio_len:duration, :].float().cpu().numpy()
        mel_out = np.swapaxes(generated, 1, 2)  # [1, d, n]
        if vocoder_fused is not None:
            # single device program, single readback: the wav comes back with
            # the mel; slice this request's generated region
            generated_wave = wav_full[
                0, ref_audio_len * hop_length: duration * hop_length].float().cpu().numpy()
        elif vocoder is not None:
            generated_wave = _vocode_bucketed(vocoder, mel_out, vocoder_bucket,
                                              model_obj.device).reshape(-1)
        else:
            generated_wave = np.zeros(mel_out.shape[-1] * hop_length, np.float32)
        if rms_val < target_rms and rms_val > 0:
            generated_wave = generated_wave * (rms_val / target_rms)

        if streaming:
            for j in range(0, len(generated_wave), chunk_size):
                yield generated_wave[j: j + chunk_size], target_sample_rate
        else:
            yield generated_wave, mel_out[0]

    if streaming:
        for gen_text in gen_text_batches:
            yield from process_batch(gen_text)
        return

    generated_waves, spectrograms = [], []
    iterator = gen_text_batches
    for gen_text in iterator:
        generated_wave, spec = next(process_batch(gen_text))
        generated_waves.append(generated_wave)
        spectrograms.append(spec)

    if not generated_waves:
        yield None, target_sample_rate, None
        return

    if cross_fade_duration <= 0:
        final_wave = np.concatenate(generated_waves)
    else:
        final_wave = generated_waves[0]
        for nxt in generated_waves[1:]:
            n_fade = int(cross_fade_duration * target_sample_rate)
            n_fade = min(n_fade, len(final_wave), len(nxt))
            if n_fade <= 0:
                final_wave = np.concatenate([final_wave, nxt])
                continue
            fade_out = np.linspace(1.0, 0.0, n_fade)
            fade_in = np.linspace(0.0, 1.0, n_fade)
            overlap = final_wave[-n_fade:] * fade_out + nxt[:n_fade] * fade_in
            final_wave = np.concatenate([final_wave[:-n_fade], overlap, nxt[n_fade:]])

    combined_spectrogram = np.concatenate(spectrograms, axis=1)
    yield final_wave, target_sample_rate, combined_spectrogram


def save_spectrogram(spectrogram: np.ndarray, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 4))
    plt.imshow(spectrogram, origin="lower", aspect="auto")
    plt.colorbar()
    plt.savefig(path)
    plt.close()


def remove_silence_for_generated_wav(filename: str) -> None:
    """Strip long silences from a generated wav in place (utils_infer.py:784-793)."""
    wav, sr = audio_utils.load_wav(filename)
    mono = audio_utils.to_mono(wav)
    spans = audio_utils.split_on_silence_spans(
        mono, sr, min_silence_ms=1000, silence_threshold_db=-50.0, keep_silence_ms=500
    )
    if spans:
        mono = np.concatenate([mono[s:e] for s, e in spans])
    audio_utils.save_wav(filename, mono, sr)
