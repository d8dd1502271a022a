"""Vocab loading, token-id mapping, and the inference tokenizer dispatch.

Parity: reference `src/f5_tts/model/utils.py:92-149` (get_tokenizer,
list_str_to_idx) and the runtime dispatch over the 12 Korean modes in
`src/f5_tts/infer/utils_infer.py:549-676` (incl. implicit mode detection from
vocab contents).
"""

from __future__ import annotations

import os

import numpy as np

from korean_f5_tts_tpu_torch.text.korean import (
    PHONEMES_C_SONORANT,
    PHONEMES_I_NO_H,
    PHONEMES_N,
    convert_char_to_allophone,
    convert_char_to_allophone_skipTC,
    convert_char_to_grapheme,
    convert_char_to_grapheme_skipTC,
    convert_char_to_no_ieung_g2p,
    convert_char_to_no_ieung_raw,
    convert_char_to_phoneme,
    convert_char_to_phoneme_skipTC,
)
from korean_f5_tts_tpu_torch.text.normalization import normalize_n2gk_plus
from korean_f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin

KOREAN_TOKENIZER_NAMES = [
    "kor_grapheme", "kor_allophone", "kor_phoneme",
    "kor_i_only", "kor_c_only", "kor_i_and_c", "kor_n_only", "kor_i_and_n",
    "kor_efficient_allophone", "kor_inf", "kor_nf",
    "kor_no_ieung_g2p", "kor_no_ieung_raw",
]
VOCAB_FILE_TOKENIZERS = ["pinyin", "char"] + KOREAN_TOKENIZER_NAMES


def load_vocab_file(path: str) -> dict[str, int]:
    vocab_char_map: dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab_char_map[line[:-1]] = i
    return vocab_char_map


def get_tokenizer(
    dataset_name: str, tokenizer: str = "pinyin", data_dir: str | None = None
) -> tuple[dict[str, int] | None, int]:
    """Resolve (vocab_char_map, vocab_size) for a dataset + tokenizer mode.

    tokenizer="custom" treats `dataset_name` as a direct path to vocab.txt;
    "byte" needs no vocab. Other modes read data/{dataset}_{tokenizer}/vocab.txt.
    """
    if tokenizer in VOCAB_FILE_TOKENIZERS:
        data_dir = data_dir or os.environ.get("F5_TTS_DATA_DIR", "data")
        path = os.path.join(data_dir, f"{dataset_name}_{tokenizer}", "vocab.txt")
        vocab_char_map = load_vocab_file(path)
        assert vocab_char_map[" "] == 0, (
            "make sure space is of idx 0 in vocab.txt, cuz 0 is used for unknown char"
        )
        return vocab_char_map, len(vocab_char_map)
    if tokenizer == "byte":
        return None, 256
    if tokenizer == "custom":
        vocab_char_map = load_vocab_file(dataset_name)
        return vocab_char_map, len(vocab_char_map)
    raise ValueError(f"unknown tokenizer mode: {tokenizer}")


def list_str_to_idx(
    text: list[str] | list[list[str]],
    vocab_char_map: dict[str, int],
    padding_value: int = -1,
    pad_to: int | None = None,
) -> np.ndarray:
    """Token lists -> [b, nt] int32 ids; unknown -> 0, pad -> -1."""
    rows = [[vocab_char_map.get(c, 0) for c in t] for t in text]
    max_len = max((len(r) for r in rows), default=0)
    if pad_to is not None:
        max_len = max(max_len, pad_to)
    out = np.full((len(rows), max_len), padding_value, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def list_str_to_tensor(text: list[str], padding_value: int = -1) -> np.ndarray:
    """UTF-8 byte tokenizer (ByT5-style)."""
    rows = [list(bytes(t, "UTF-8")) for t in text]
    max_len = max((len(r) for r in rows), default=0)
    out = np.full((len(rows), max_len), padding_value, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def detect_tokenizer_type(vocab: dict[str, int]) -> str:
    """Implicit mode detection from vocab contents (utils_infer.py:570,647,662)."""
    if any(("ⁱ" in k) or ("ᶜ" in k) or ("ʲ" in k) for k in vocab):
        return "kor_allophone"
    if "ㄱ" in vocab:
        return "kor_phoneme"
    if "ㅄ" in vocab:
        return "kor_grapheme"
    return "pinyin"


_CUSTOM_MODE_FLAGS = {
    # mode -> (apply_init, apply_coda, coda_filter, initial_filter)
    "kor_i_only": (True, False, None, None),
    "kor_c_only": (False, True, None, None),
    "kor_i_and_c": (True, True, None, None),
    "kor_n_only": (False, True, PHONEMES_N, None),
    "kor_i_and_n": (True, True, PHONEMES_N, None),
    "kor_efficient_allophone": (True, True, PHONEMES_C_SONORANT, PHONEMES_I_NO_H),
    "kor_inf": (True, True, PHONEMES_C_SONORANT, None),
    "kor_nf": (False, True, PHONEMES_C_SONORANT, None),
}


def tokenize_text(
    text_list: list[str],
    tokenizer_type: str = "custom",
    vocab: dict[str, int] | None = None,
    use_n2gk_plus: bool = True,
    use_skip_tc: bool = False,
    legacy: bool = False,
) -> list[list[str]] | list[str]:
    """Full inference-time tokenizer dispatch (utils_infer.py:549-676).

    Returns per-utterance token lists ready for `list_str_to_idx`.
    """
    if vocab is None:
        return convert_char_to_pinyin(text_list)

    mode = tokenizer_type
    if mode == "custom":
        mode = detect_tokenizer_type(vocab)

    if mode not in KOREAN_TOKENIZER_NAMES:
        return convert_char_to_pinyin(text_list)

    if use_n2gk_plus:
        text_list = [normalize_n2gk_plus(t) for t in text_list]

    if mode == "kor_grapheme":
        if use_skip_tc:
            return convert_char_to_grapheme_skipTC(text_list, legacy=legacy)
        return convert_char_to_grapheme(text_list)
    if mode == "kor_allophone":
        if use_skip_tc:
            return convert_char_to_allophone_skipTC(text_list, legacy=legacy)
        return convert_char_to_allophone(text_list)
    if mode in _CUSTOM_MODE_FLAGS:
        apply_init, apply_coda, coda_filter, initial_filter = _CUSTOM_MODE_FLAGS[mode]
        return convert_char_to_allophone(
            text_list,
            apply_init=apply_init,
            apply_pal=False,
            apply_coda=apply_coda,
            coda_filter=coda_filter,
            initial_filter=initial_filter,
        )
    if mode == "kor_no_ieung_g2p":
        return convert_char_to_no_ieung_g2p(text_list)
    if mode == "kor_no_ieung_raw":
        return convert_char_to_no_ieung_raw(text_list)
    if mode == "kor_phoneme":
        if use_skip_tc:
            return convert_char_to_phoneme_skipTC(text_list, legacy=legacy)
        return convert_char_to_phoneme(text_list)
    raise AssertionError(f"unhandled tokenizer mode {mode}")
