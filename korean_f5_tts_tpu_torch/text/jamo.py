"""Hangul jamo tables and syllable (de)composition.

Parity: reference `src/f5_tts/model/utils.py:169-218` (jamo tables,
`_syllable_to_phonemes`). Pure host-side Python.
"""

from __future__ import annotations

CHOSEONG = ["ㄱ", "ㄲ", "ㄴ", "ㄷ", "ㄸ", "ㄹ", "ㅁ", "ㅂ", "ㅃ", "ㅅ",
            "ㅆ", "ㅇ", "ㅈ", "ㅉ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]
JUNGSEONG = ["ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ",
             "ㅙ", "ㅚ", "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ"]
JONGSEONG = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ",
             "ㄻ", "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ",
             "ㅆ", "ㅇ", "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]

_CHO_IDX = {c: i for i, c in enumerate(CHOSEONG)}
_JUNG_IDX = {c: i for i, c in enumerate(JUNGSEONG)}
_JONG_IDX = {c: i for i, c in enumerate(JONGSEONG)}

_HANGUL_BASE = ord("가")
_HANGUL_END = ord("힣")


def is_hangul_syllable(ch: str) -> bool:
    return _HANGUL_BASE <= ord(ch) <= _HANGUL_END


def decompose(ch: str) -> tuple[str, str, str]:
    """Syllable -> (choseong, jungseong, jongseong); jongseong '' if none."""
    base = ord(ch) - _HANGUL_BASE
    return (
        CHOSEONG[base // 588],
        JUNGSEONG[(base % 588) // 28],
        JONGSEONG[base % 28],
    )


def compose(cho: str, jung: str, jong: str = "") -> str:
    return chr(_HANGUL_BASE + _CHO_IDX[cho] * 588 + _JUNG_IDX[jung] * 28 + _JONG_IDX[jong])


def syllable_to_phonemes(syllable: str) -> list[str]:
    """Syllable -> [cho, jung, jong] (jong may be ''); pass-through otherwise.

    Parity: reference `model/utils.py:207-218`.
    """
    if is_hangul_syllable(syllable):
        return list(decompose(syllable))
    return [syllable]
