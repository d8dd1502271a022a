"""Mel-domain speech editing: regenerate selected time spans of an utterance
(counterpart of korean_f5_tts_tpu/infer/speech_edit.py): python -m
korean_f5_tts_tpu_torch.infer.speech_edit, on the card unless --device cpu.

Parity with reference `src/f5_tts/infer/speech_edit.py`: frame-level
`mel_cond` + `edit_mask` construction from (start, end) second spans
(`:155-195`) and sampling with `edit_mask` so everything outside the edited
spans is preserved (`:210-220`). Alignment of parts-to-edit is supplied by
the caller (the reference shells out to ctc-forced-aligner, `:66-72`).
"""

from __future__ import annotations

import numpy as np

from korean_f5_tts_tpu_torch.infer.utils_infer import _vocode_bucketed
from korean_f5_tts_tpu_torch.models.cfm import cfm_sample
from korean_f5_tts_tpu_torch.text.vocab import list_str_to_idx, tokenize_text


def build_edit_mask(n_frames: int, edit_spans_s: list[tuple[float, float]],
                    sample_rate: int = 24_000, hop_length: int = 256,
                    fix_durations_s: list[float] | None = None):
    """-> (keep_mask [n_out], out_frames): True where original audio is kept.

    With fix_durations, each edited span is re-timed to the given length and
    the surrounding audio shifts accordingly (speech_edit.py:155-195).
    """
    def to_frames(sec: float) -> int:
        return int(sec * sample_rate / hop_length)

    keep = []
    offsets = []  # (src_start_frame, src_len) per kept segment
    cursor = 0
    for i, (s, e) in enumerate(edit_spans_s):
        s_f, e_f = to_frames(s), to_frames(e)
        keep.extend([True] * (s_f - cursor))
        offsets.append((cursor, s_f - cursor))
        new_len = to_frames(fix_durations_s[i]) if fix_durations_s else e_f - s_f
        keep.extend([False] * new_len)
        cursor = e_f
    keep.extend([True] * (n_frames - cursor))
    offsets.append((cursor, n_frames - cursor))
    return np.asarray(keep, bool), offsets


def edit_speech(
    model_obj,
    wav: np.ndarray,
    orig_text: str,
    target_text: str,
    edit_spans_s: list[tuple[float, float]],
    fix_durations_s: list[float] | None = None,
    nfe_step: int = 32,
    cfg_strength: float = 2.0,
    sway_sampling_coef: float = -1.0,
    seed: int | None = None,
    vocoder=None,
    attn_path: str = "default",
    attn_int8: str | None = None,
):
    """Regenerate the edited spans of `wav` to speak `target_text`. Returns
    the waveform [samples] when a vocoder is given, else the mel
    [n_out, n_mels], as host arrays."""
    mel = model_obj.mel_of_wav(wav)  # [n, d]
    n_src = mel.shape[0]
    keep, offsets = build_edit_mask(n_src, edit_spans_s,
                                    model_obj.mel.target_sample_rate,
                                    model_obj.mel.hop_length, fix_durations_s)
    n_out = len(keep)
    # conditioning mel re-timed into the output timeline: kept segments copy
    # in order onto the True positions of the keep mask
    cond = np.zeros((n_out, mel.shape[1]), np.float32)
    dst_positions = np.flatnonzero(keep)
    src_positions = (
        np.concatenate([np.arange(s, s + l) for s, l in offsets if l > 0])
        if any(l > 0 for _, l in offsets) else np.array([], int)
    )
    n_copy = min(len(dst_positions), len(src_positions))
    cond[dst_positions[:n_copy]] = mel[src_positions[:n_copy]]

    token_lists = tokenize_text(
        [target_text], tokenizer_type=model_obj.tokenizer_type,
        vocab=model_obj.vocab_char_map, use_n2gk_plus=model_obj.use_n2gk_plus,
        use_skip_tc=model_obj.use_skip_tc,
    )
    text_ids = list_str_to_idx(token_lists, model_obj.vocab_char_map or {" ": 0})

    out, _ = cfm_sample(
        model_obj.params, model_obj.arch, cond[None], text_ids,
        duration=n_out, lens=np.array([n_out]), steps=nfe_step,
        cfg_strength=cfg_strength, sway_sampling_coef=sway_sampling_coef,
        seed=seed, edit_mask=keep[None], attn_path=attn_path, attn_int8=attn_int8,
    )
    out = out[:, :n_out, :].float().cpu().numpy()
    if vocoder is not None:
        return _vocode_bucketed(vocoder, np.swapaxes(out, 1, 2),
                                device=model_obj.device).reshape(-1)
    return out[0]


def main(argv=None):
    """CLI: regenerate time spans of a wav (reference speech_edit.py script role)."""
    import argparse

    from korean_f5_tts_tpu_torch.serving.server import add_model_arguments, load_from_arguments
    from korean_f5_tts_tpu_torch.utils.audio import load_wav, save_wav, to_mono

    p = argparse.ArgumentParser(prog="f5-tts_speech-edit")
    add_model_arguments(p)
    p.add_argument("--wav", required=True)
    p.add_argument("--orig_text", required=True)
    p.add_argument("--target_text", required=True)
    p.add_argument("--edit_spans", required=True,
                   help="start:end second pairs, comma separated (e.g. 0.5:1.2,2.0:2.4)")
    p.add_argument("--fix_durations", default=None,
                   help="re-timed span lengths in seconds, comma separated")
    p.add_argument("--output", default="edited.wav")
    p.add_argument("--nfe_step", type=int, default=32)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    spans = [tuple(float(x) for x in s.split(":")) for s in args.edit_spans.split(",")]
    fixes = ([float(x) for x in args.fix_durations.split(",")]
             if args.fix_durations else None)
    model_obj, vocoder = load_from_arguments(args)
    wav, sr = load_wav(args.wav)
    out = edit_speech(model_obj, to_mono(wav), args.orig_text, args.target_text,
                      spans, fix_durations_s=fixes, nfe_step=args.nfe_step,
                      seed=args.seed, vocoder=vocoder, attn_path=args.attn_path,
                      attn_int8=args.attn_int8)
    save_wav(args.output, out, model_obj.mel.target_sample_rate)
    print(args.output)


if __name__ == "__main__":
    main()
