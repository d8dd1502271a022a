"""Pinyin G2P for Chinese text (Emilia ZH/EN training path).

Parity: reference `src/f5_tts/model/utils.py:481-518`. The reference uses
rjieba + pypinyin; neither is available in this image, so segmentation falls
back to `jieba` when present and per-character otherwise, and pinyin
conversion uses pypinyin when installed, else the VENDORED table
(text/pinyin_data.py: ~1k most-frequent hanzi, polyphone word overrides,
不/一/third-tone sandhi) — ZH text tokenizes into the same pinyin-syllable
vocab either way. Known divergence vs pypinyin: rarer characters fall back
to the raw char, and sandhi windows are hanzi runs, not jieba words
(documented in PARITY.md).
"""

from __future__ import annotations

try:  # pragma: no cover - environment probe
    from pypinyin import Style, lazy_pinyin

    def _pinyin(seg: str) -> list[str]:
        return lazy_pinyin(seg, style=Style.TONE3, tone_sandhi=True)

    HAS_PYPINYIN = True
except ImportError:
    HAS_PYPINYIN = False

    def _pinyin(seg: str) -> list[str]:
        from korean_f5_tts_tpu_torch.text.pinyin_data import hanzi_to_pinyin

        return hanzi_to_pinyin(seg)


try:  # pragma: no cover - environment probe
    import jieba

    def _segment(text: str):
        return jieba.cut(text)

    HAS_JIEBA = True
except ImportError:  # pragma: no cover
    HAS_JIEBA = False

    def _segment(text: str):
        return [text]


_CUSTOM_TRANS = str.maketrans({";": ",", "“": '"', "”": '"', "‘": "'", "’": "'"})


def _is_chinese(c: str) -> bool:
    return "㄀" <= c <= "鿿"


def convert_char_to_pinyin(text_list: list[str], polyphone: bool = True) -> list[list[str]]:
    final_text_list = []
    for text in text_list:
        char_list: list[str] = []
        text = text.translate(_CUSTOM_TRANS)
        for seg in _segment(text):
            seg_byte_len = len(bytes(seg, "UTF-8"))
            if seg_byte_len == len(seg):  # pure alphabets/symbols
                if char_list and seg_byte_len > 1 and char_list[-1] not in " :'\"":
                    char_list.append(" ")
                char_list.extend(seg)
            elif polyphone and seg_byte_len == 3 * len(seg):  # pure east asian
                seg_ = _pinyin(seg)
                for i, c in enumerate(seg):
                    if _is_chinese(c):
                        char_list.append(" ")
                    char_list.append(seg_[i])
            else:  # mixed
                for c in seg:
                    if ord(c) < 256:
                        char_list.extend(c)
                    elif _is_chinese(c):
                        char_list.append(" ")
                        char_list.extend(_pinyin(c))
                    else:
                        char_list.append(c)
        final_text_list.append(char_list)
    return final_text_list
