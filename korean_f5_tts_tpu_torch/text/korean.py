"""Korean grapheme-to-allophone (G2A) tokenizer family.

Parity: reference `src/f5_tts/model/utils.py:169-475` — jamo tables, allophone
marks (ⁱ ᶜ ʲ), SkipTC token '*', `_classify_into_allophones`, and the 12
converter front-ends (grapheme/phoneme/allophone ± skipTC, no-ieung ×2, and
filtered modes i_only / c_only / i_and_c / n_only / i_and_n / inf / nf /
efficient_allophone).

The G2P backend is this framework's own rule engine
(`korean_f5_tts_tpu_torch/text/g2p_ko.py`); the reference used the external g2pk2
package. The classification layer below is byte-for-byte the same mapping from
a pronunciation string to allophone tokens.
"""

from __future__ import annotations

from typing import Callable

from korean_f5_tts_tpu_torch.text.g2p_ko import g2p
from korean_f5_tts_tpu_torch.text.jamo import syllable_to_phonemes

# -- target phoneme classes (reference utils.py:177-184) ---------------------

PHONEMES_I = ["ㄱ", "ㄷ", "ㅂ", "ㅈ", "ㅎ"]  # word-initial devoiced lenis
PHONEMES_I_NO_H = ["ㄱ", "ㄷ", "ㅂ", "ㅈ"]
PHONEMES_P = ["ㅅ"]  # palatalises before [j]/[i]
PHONEMES_C = ["ㄱ", "ㄴ", "ㄷ", "ㄹ", "ㅁ", "ㅂ", "ㅇ"]  # coda allophones
PHONEMES_C_SONORANT = ["ㄴ", "ㄹ", "ㅁ", "ㅇ"]
PHONEMES_N = ["ㄴ", "ㅁ", "ㅇ"]
VOWELS_Y = ["ㅣ", "ㅑ", "ㅕ", "ㅛ", "ㅠ", "ㅖ", "ㅒ", "ㅟ"]

MARK_INIT = "ⁱ"  # word-initial onset (voiceless)
MARK_CODA = "ᶜ"  # coda (unreleased/lateral)
MARK_PAL = "ʲ"  # palatalized

# SkipTC: syllable-boundary token when there is no coda.
# New version uses explicit '*'; legacy (2026-02-07) used ''.
SKIPTC_TOKEN = "*"
LEGACY_SKIPTC_TOKEN = ""


def _pronunciation_to_eojeols(text: str) -> list[str]:
    return text.split(" ")


def classify_into_allophones(
    phonemes: list[str],
    is_eojeol_initial: bool,
    add_empty_jong: bool = False,
    skip_tc_token: str = SKIPTC_TOKEN,
    apply_init: bool = True,
    apply_pal: bool = True,
    apply_coda: bool = True,
    coda_filter: list[str] | None = None,
    initial_filter: list[str] | None = None,
) -> list[str]:
    """Classify one syllable's [cho, jung, jong] into allophone tokens.

    Parity: reference `model/utils.py:220-278`.
    """
    if len(phonemes) <= 2:
        return phonemes
    cho, jung, jong = phonemes[:3]

    allophones: list[str] = []
    # onset
    if apply_init and is_eojeol_initial:
        targets = initial_filter if initial_filter is not None else PHONEMES_I
        if cho in targets:
            allophones.append(cho + MARK_INIT)
        elif apply_pal and cho in PHONEMES_P and jung in VOWELS_Y:
            allophones.append(cho + MARK_PAL)
        else:
            allophones.append(cho)
    elif apply_pal and cho in PHONEMES_P and jung in VOWELS_Y:
        allophones.append(cho + MARK_PAL)
    else:
        allophones.append(cho)

    # nucleus
    allophones.append(jung)

    # coda
    if jong:
        if apply_coda:
            targets = coda_filter if coda_filter is not None else PHONEMES_C
            allophones.append(jong + MARK_CODA if jong in targets else jong)
        else:
            allophones.append(jong)
    elif add_empty_jong:
        allophones.append(skip_tc_token)

    return allophones


def _convert_allophone_impl(
    text_list: list[str],
    add_empty_jong: bool,
    skip_tc_token: str = SKIPTC_TOKEN,
    apply_init: bool = True,
    apply_pal: bool = True,
    apply_coda: bool = True,
    coda_filter: list[str] | None = None,
    initial_filter: list[str] | None = None,
    pre_g2p: bool = False,
) -> list[list[str]]:
    final = []
    for text in text_list:
        result: list[str] = []
        for eojeol in _pronunciation_to_eojeols(text if pre_g2p else g2p(text)):
            for i, syllable in enumerate(eojeol):
                result.extend(
                    classify_into_allophones(
                        syllable_to_phonemes(syllable),
                        is_eojeol_initial=(i == 0),
                        add_empty_jong=add_empty_jong,
                        skip_tc_token=skip_tc_token,
                        apply_init=apply_init,
                        apply_pal=apply_pal,
                        apply_coda=apply_coda,
                        coda_filter=coda_filter,
                        initial_filter=initial_filter,
                    )
                )
            result.append(" ")
        if result and result[-1] == " ":
            result.pop()
        final.append(result)
    return final


# -- converter front-ends (reference utils.py:280-475) -----------------------


def convert_char_to_allophone(
    text_list: list[str],
    apply_init: bool = True,
    apply_pal: bool = True,
    apply_coda: bool = True,
    coda_filter: list[str] | None = None,
    initial_filter: list[str] | None = None,
) -> list[list[str]]:
    """Allophone tokens, no syllable-boundary token for empty coda."""
    return _convert_allophone_impl(
        text_list,
        add_empty_jong=False,
        apply_init=apply_init,
        apply_pal=apply_pal,
        apply_coda=apply_coda,
        coda_filter=coda_filter,
        initial_filter=initial_filter,
    )


def convert_char_to_allophone_skipTC(
    text_list: list[str], legacy: bool = False
) -> list[list[str]]:
    """Allophone tokens with SkipTC boundary token ('*', or '' if legacy).

    The reference calls this with a `legacy=` kwarg its own definition lacks
    (`utils_infer.py:564` vs `utils.py:300-306`) — a latent TypeError noted in
    SURVEY.md §7; implemented coherently here.
    """
    return _convert_allophone_impl(
        text_list,
        add_empty_jong=True,
        skip_tc_token=LEGACY_SKIPTC_TOKEN if legacy else SKIPTC_TOKEN,
    )


def convert_char_to_grapheme(text_list: list[str]) -> list[list[str]]:
    """Jamo decomposition, no G2P; empty coda dropped."""
    final = []
    for text in text_list:
        result: list[str] = []
        for ch in text:
            if ch == " ":
                result.append(" ")
            else:
                result.extend(j for j in syllable_to_phonemes(ch) if j)
        final.append(result)
    return final


def convert_char_to_grapheme_skipTC(
    text_list: list[str], legacy: bool = False
) -> list[list[str]]:
    """Jamo decomposition, no G2P; empty coda -> SkipTC token."""
    token = LEGACY_SKIPTC_TOKEN if legacy else SKIPTC_TOKEN
    final = []
    for text in text_list:
        result: list[str] = []
        for ch in text:
            if ch == " ":
                result.append(" ")
            else:
                for j in syllable_to_phonemes(ch):
                    result.append(j if j else token)
        final.append(result)
    return final


def convert_char_to_phoneme(text_list: list[str]) -> list[list[str]]:
    """Standard phonemes (G2P applied); empty coda dropped."""
    final = []
    for text in text_list:
        result: list[str] = []
        for eojeol in _pronunciation_to_eojeols(g2p(text)):
            for syllable in eojeol:
                result.extend(p for p in syllable_to_phonemes(syllable) if p)
            result.append(" ")
        if result and result[-1] == " ":
            result.pop()
        final.append(result)
    return final


def convert_char_to_phoneme_skipTC(
    text_list: list[str], legacy: bool = False
) -> list[list[str]]:
    """Standard phonemes (G2P applied); empty coda -> SkipTC token."""
    token = LEGACY_SKIPTC_TOKEN if legacy else SKIPTC_TOKEN
    final = []
    for text in text_list:
        result: list[str] = []
        for eojeol in _pronunciation_to_eojeols(g2p(text)):
            for syllable in eojeol:
                for p in syllable_to_phonemes(syllable):
                    result.append(p if p else token)
            result.append(" ")
        if result and result[-1] == " ":
            result.pop()
        final.append(result)
    return final


def _no_ieung(phonemes: list[str]) -> list[str]:
    if phonemes and phonemes[0] == "ㅇ":
        return [p for p in phonemes[1:] if p]
    return [p for p in phonemes if p]


def convert_char_to_no_ieung_g2p(text_list: list[str]) -> list[list[str]]:
    """Phonemes (G2P) with initial silent ㅇ removed."""
    final = []
    for text in text_list:
        result: list[str] = []
        for eojeol in _pronunciation_to_eojeols(g2p(text)):
            for syllable in eojeol:
                result.extend(_no_ieung(syllable_to_phonemes(syllable)))
            result.append(" ")
        if result and result[-1] == " ":
            result.pop()
        final.append(result)
    return final


def convert_char_to_no_ieung_raw(text_list: list[str]) -> list[list[str]]:
    """Raw jamo (no G2P) with initial silent ㅇ removed."""
    final = []
    for text in text_list:
        result: list[str] = []
        for ch in text:
            if ch == " ":
                result.append(" ")
            else:
                result.extend(_no_ieung(syllable_to_phonemes(ch)))
        final.append(result)
    return final


# -- named tokenizer modes ---------------------------------------------------
# Maps the reference's 12 Korean tokenizer modes (get_tokenizer names at
# utils.py:129 and the dispatch in utils_infer.py:556-676) to converters.

KOREAN_CONVERTERS: dict[str, Callable[[list[str]], list[list[str]]]] = {
    "kor_grapheme": convert_char_to_grapheme,
    "kor_phoneme": convert_char_to_phoneme,
    "kor_allophone": convert_char_to_allophone,
    "kor_i_only": lambda t: convert_char_to_allophone(t, apply_pal=False, apply_coda=False),
    "kor_c_only": lambda t: convert_char_to_allophone(t, apply_init=False, apply_pal=False),
    "kor_i_and_c": lambda t: convert_char_to_allophone(t, apply_pal=False),
    "kor_n_only": lambda t: convert_char_to_allophone(
        t, apply_init=False, apply_pal=False, coda_filter=PHONEMES_N
    ),
    "kor_i_and_n": lambda t: convert_char_to_allophone(
        t, apply_pal=False, coda_filter=PHONEMES_N
    ),
    "kor_inf": lambda t: convert_char_to_allophone(
        t, apply_init=True, apply_pal=False, coda_filter=PHONEMES_C_SONORANT
    ),
    "kor_nf": lambda t: convert_char_to_allophone(
        t, apply_init=False, apply_pal=False, coda_filter=PHONEMES_C_SONORANT
    ),
    "kor_efficient_allophone": lambda t: convert_char_to_allophone(
        t, apply_pal=False, initial_filter=PHONEMES_I_NO_H, coda_filter=PHONEMES_C_SONORANT
    ),
    "kor_no_ieung_g2p": convert_char_to_no_ieung_g2p,
    "kor_no_ieung_raw": convert_char_to_no_ieung_raw,
}


# -- pronunciation-input ("salt") converters ---------------------------------
# CoreaSpeech ships a pre-G2P pronunciation column; these decompose it
# directly without running g2p() first (the whole point: the corpus carries
# human/ASR-verified pronunciations). Reference:
# prepare_coreaspeech_salt_n.py:30-50 and prepare_coreaspeech_salt_vcp.py:35-54.


def convert_pronunciation_to_salt_n(
    text_list: list[str], use_skip_tc: bool = False, legacy: bool = False
) -> list[list[str]]:
    """salt-n: nasal-coda allophones only (coda_filter=PHONEMES_N), no
    word-initial or palatalisation marks, on pre-G2P pronunciation text."""
    return _convert_allophone_impl(
        text_list,
        add_empty_jong=use_skip_tc,
        skip_tc_token="" if legacy else SKIPTC_TOKEN,
        apply_init=False,
        apply_pal=False,
        apply_coda=True,
        coda_filter=PHONEMES_N,
        pre_g2p=True,
    )


def convert_pronunciation_to_salt_vcp(
    text_list: list[str], use_skip_tc: bool = False, legacy: bool = False
) -> list[list[str]]:
    """salt-vcp: full i/c/p allophone marks (init+pal+all codas) on pre-G2P
    pronunciation text."""
    return _convert_allophone_impl(
        text_list,
        add_empty_jong=use_skip_tc,
        skip_tc_token="" if legacy else SKIPTC_TOKEN,
        apply_init=True,
        apply_pal=True,
        apply_coda=True,
        coda_filter=None,
        pre_g2p=True,
    )


PRONUNCIATION_CONVERTERS: dict[str, Callable[..., list[list[str]]]] = {
    "kor_salt_n": convert_pronunciation_to_salt_n,
    "kor_salt_vcp": convert_pronunciation_to_salt_vcp,
}
