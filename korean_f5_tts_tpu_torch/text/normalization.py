"""Korean text normalisation: number-to-grapheme (N2gk) and N2gk+ pipelines.

Behavioural parity with reference
`src/f5_tts/train/datasets/normalization_n2gk.py` (N2gk `:6-389`, N2gkPlus
`:391-696`): numbers are expanded to Korean words choosing native (고유어) vs
sino (한자어) readings by the following counter unit, with special handling for
phone numbers, ranges (~), decimals, exception idioms, symbol/abbreviation
maps, single Latin letters, bare jamo names, and historic event dates.

Structured here as a pipeline of small pure functions over the sentence
string; the reading tables are shared module-level constants.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------------------
# Reading tables
# ---------------------------------------------------------------------------

SINO_DIGITS = ["", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]
SINO_SMALL_UNITS = ["", "십", "백", "천"]
SINO_LARGE_UNITS = ["", "만", "억", "조", "경"]
# units where a leading 1 is always read out ("일억", never "억")
SINO_KEEP_ONE = {"억", "조", "경"}

PHONE_DIGITS = ["공", "일", "이", "삼", "사", "오", "육", "칠", "팔", "구"]

NATIVE_ONES = {
    1: ("하나", "한"), 2: ("둘", "두"), 3: ("셋", "세"), 4: ("넷", "네"),
    5: ("다섯", "다섯"), 6: ("여섯", "여섯"), 7: ("일곱", "일곱"),
    8: ("여덟", "여덟"), 9: ("아홉", "아홉"),
}
NATIVE_TENS = {
    10: "열", 20: "스물", 30: "서른", 40: "마흔", 50: "쉰",
    60: "예순", 70: "일흔", 80: "여든", 90: "아흔",
}
NATIVE_PREFIX_TENS = {20: "스무"}

ENGLISH_NUMBER_WORDS = {
    0: "제로", 1: "원", 2: "투", 3: "쓰리", 4: "포", 5: "파이브",
    6: "식스", 7: "세븐", 8: "에잇", 9: "나인", 10: "텐",
}

# idiom-level exceptions applied before everything else
EXCEPTION_PATTERNS = [
    (r"\b20\s?살\b", "스무 살"),
    (r"\b1\s?등\b", "일 등"),
    (r"(?<!\d)(0?6)\s*월", "유월"),
    (r"(?<!\d)(10)\s*월", "시월"),
]

# counter units and the reading style they select. Order within a tuple does
# not matter; lookup is longest-unit-first across all categories.
_NATIVE = "native"
_SINO = "sino"

METRIC_UNIT_NAMES = {
    "kg": "킬로그램", "Kg": "킬로그램", "g": "그램", "mg": "밀리그램",
    "t": "톤", "T": "톤", "l": "리터", "L": "리터", "ml": "밀리리터",
    "cm": "센티미터", "mm": "밀리미터", "m": "미터", "km": "킬로미터",
    "k": "케이", "K": "케이", "ha": "헥타르",
}

UNIT_TABLE: list[tuple[tuple[str, ...], str, bool]] = [
    # (units, style, spell_out_unit_name)
    (("명", "사람", "마리", "번째", "시", "배", "방", "가구", "게임", "건", "세트"), _NATIVE, False),
    (("개", "가지", "개비", "잔", "번", "장", "병", "권", "벌", "곳", "시간", "척",
      "차례", "바퀴", "경기", "골"), _NATIVE, False),
    (("초", "분", "일", "주", "개월", "월", "년"), _SINO, False),
    (("점", "포인트", "퍼센트", "%레벨", "점수", "등급", "등", "개국", "볼트"), _SINO, False),
    (("원", "달러", "유로", "엔", "조", "페소", "베럴"), _SINO, False),
    # NB: reference has adjacent-string-literal concatenations
    # ('k' '킬로그램' -> 'k킬로그램', '%' '레벨' -> '%레벨',
    # normalization_n2gk.py:51-54); reproduced for behaviour parity.
    (("kg", "Kg", "mg", "g", "t", "T", "l", "L", "ml", "cm", "mm", "m", "km",
      "k킬로그램", "미리그램", "그램", "톤", "리터", "미리리터", "센치미터",
      "미리미터", "미터", "키로미터", "케이"), _SINO, True),
    (("회", "차", "기", "호", "페이지", "장"), _SINO, False),
    (("코어", "스레드", "파일", "채널", "명령어"), _SINO, False),
    (("살", "연세", "춘추"), _NATIVE, False),
    (("도", "℃", "°C", "C"), _SINO, True),
]

# ---------------------------------------------------------------------------
# Core readers
# ---------------------------------------------------------------------------


def read_native(num: int, prefix: bool = False) -> str:
    """Native-Korean (고유어) reading, 1..99. prefix=True gives 한/두/세/…"""
    if num <= 9:
        pair = NATIVE_ONES.get(num)
        if pair is None:
            return "영"
        return pair[1] if prefix else pair[0]
    if num == 10:
        return "열"
    if num < 100:
        tens, ones = (num // 10) * 10, num % 10
        if prefix and ones == 0 and tens in NATIVE_PREFIX_TENS:
            return NATIVE_PREFIX_TENS[tens]
        head = NATIVE_TENS.get(tens, "")
        return head + read_native(ones, prefix=prefix) if ones else head
    raise ValueError("native readings are defined up to 99")


def _read_4digit_chunk(chunk: str, natural: bool) -> str:
    out = ""
    n = len(chunk)
    for i, ch in enumerate(chunk):
        d = int(ch)
        if d == 0:
            continue
        unit = SINO_SMALL_UNITS[n - i - 1]
        if d == 1 and unit and natural:
            out += unit
        else:
            out += SINO_DIGITS[d] + unit
    return out


def read_sino(num, natural: bool = True) -> str:
    """Sino-Korean (한자어) reading of an int/float/str."""
    if isinstance(num, float):
        int_part = int(num)
        frac = str(num).split(".")[1]
        frac_read = "".join(SINO_DIGITS[int(c)] if c != "0" else "영" for c in frac)
        return f"{read_sino(int_part, natural)}점{frac_read}"
    if isinstance(num, str):
        try:
            val = float(num) if "." in num else int(num)
        except ValueError:
            return str(num)
        return read_sino(val, natural)
    if num == 0:
        return "영"
    if num < 0:
        return "마이너스 " + read_sino(-num, natural)
    digits = str(num)
    chunks = [digits[max(i - 4, 0): i] for i in range(len(digits), 0, -4)][::-1]
    if len(chunks) > 5:
        return str(num)
    out = ""
    for i, chunk in enumerate(chunks):
        if int(chunk) == 0:
            continue
        part = _read_4digit_chunk(chunk.zfill(4), natural)
        unit = SINO_LARGE_UNITS[len(chunks) - i - 1]
        if part == "일" and unit:
            if (natural and unit not in SINO_KEEP_ONE) or (not natural and unit in SINO_KEEP_ONE):
                part = ""
        out += part + unit
    return out


def _unit_lookup() -> list[tuple[str, str, bool]]:
    pairs = []
    for units, style, spell in UNIT_TABLE:
        for u in units:
            pairs.append((u, style, spell))
    pairs.sort(key=lambda x: len(x[0]), reverse=True)
    return pairs


_UNIT_PAIRS = _unit_lookup()


def _read_with_unit_style(num, unit: str, style: str, spell: bool, natural: bool) -> str:
    display = METRIC_UNIT_NAMES[unit] if spell and unit in METRIC_UNIT_NAMES else unit
    if style == _NATIVE:
        return read_native(int(num), prefix=True) + display
    return read_sino(num, natural=natural) + display


def read_with_unit(num, unit: str, natural: bool = True) -> str:
    """Number + counter word, choosing native vs sino reading by the unit."""
    for u, style, spell in _UNIT_PAIRS:
        if unit == u:
            return _read_with_unit_style(num, unit, style, spell, natural)
    return read_sino(num, natural=natural) + unit


# ---------------------------------------------------------------------------
# N2gk pipeline stages
# ---------------------------------------------------------------------------

_NUM = r"\d{1,3}(?:,\d{3})*|\d+"


def expand_exceptions(text: str) -> str:
    for pat, repl in EXCEPTION_PATTERNS:
        text = re.sub(pat, repl, text)
    return text


def expand_english_numbers(text: str) -> str:
    """'MP3' style: small numbers after Latin words read in English-Korean."""
    def repl(m):
        n = int(m.group(2))
        word = ENGLISH_NUMBER_WORDS[n] if 0 <= n <= 10 else str(n)
        return f"{m.group(1)} {word}"
    return re.sub(r"([a-zA-Z]+)(\d+)", repl, text)


def expand_phone_numbers(text: str) -> str:
    def digits(s):
        return "".join(PHONE_DIGITS[int(d)] for d in s)

    text = re.sub(
        r"(?<!\d)(\d{3})-(\d{3,4})-(\d{4})(?!\d)",
        lambda m: "-".join(digits(m.group(i)) for i in (1, 2, 3)),
        text,
    )
    text = re.sub(
        r"(?<!\d)(\d{11})(?!\d)",
        lambda m: f"{digits(m.group(1)[:3])}-{digits(m.group(1)[3:7])}-{digits(m.group(1)[7:])}",
        text,
    )
    return text


def expand_ranges(text: str, natural: bool = True) -> str:
    """'3~5개' -> '세에서 다섯 개' style."""
    pat = rf"({_NUM}(?:\.\d+)?)\s*~\s*({_NUM}(?:\.\d+)?)\s*([가-힣a-zA-Z]+)"

    def repl(m):
        try:
            lo_s, hi_s = m.group(1).replace(",", ""), m.group(2).replace(",", "")
            lo = float(lo_s) if "." in lo_s else int(lo_s)
            hi = float(hi_s) if "." in hi_s else int(hi_s)
            unit = m.group(3)
            lo_r = read_with_unit(lo, unit, natural).replace(unit, "")
            hi_r = read_with_unit(hi, unit, natural).replace(unit, "")
            return f"{lo_r}에서 {hi_r} {unit}"
        except Exception:
            return m.group(0)

    return re.sub(pat, repl, text)


def expand_number_with_counter(text: str, natural: bool = True) -> str:
    pat = rf"({_NUM}(?:\.\d+)?)\s?([가-힣a-zA-Z]+)"

    def repl(m):
        raw, word = m.group(1).replace(",", ""), m.group(2)
        try:
            num = float(raw) if "." in raw else int(raw)
            for u, style, spell in _UNIT_PAIRS:
                if word.startswith(u):
                    return _read_with_unit_style(num, u, style, spell, natural) + word[len(u):]
        except Exception:
            pass
        return m.group(0)

    return re.sub(pat, repl, text)


def space_around_numbers(text: str) -> str:
    text = re.sub(r"([가-힣a-zA-Z])(\d)", r"\1 \2", text)
    return re.sub(r"(\d)([가-힣a-zA-Z])", r"\1 \2", text)


def expand_floats(text: str) -> str:
    def repl(m):
        s = m.group(1)
        try:
            trailing_zeros = len(s) - len(s.rstrip("0")) if s.endswith("0") else 0
            return read_sino(float(s)) + "영" * trailing_zeros
        except Exception:
            return s
    return re.sub(r"(\d+\.\d+)", repl, text)


def expand_plain_numbers(text: str, natural: bool = True) -> str:
    pat = rf"(?<![\d가-힣])({_NUM})(?![\d가-힣])"
    return re.sub(pat, lambda m: read_sino(int(m.group(1).replace(",", "")), natural), text)


class N2gk:
    """Number-to-Korean-grapheme normaliser (reference `:6-389`)."""

    def __init__(self, natural: bool = True):
        self.natural = natural

    def __call__(self, sentence: str) -> str:
        sentence = expand_exceptions(sentence)
        sentence = expand_english_numbers(sentence)
        sentence = expand_phone_numbers(sentence)
        sentence = expand_ranges(sentence, self.natural)
        sentence = expand_number_with_counter(sentence, self.natural)
        sentence = space_around_numbers(sentence)
        sentence = expand_floats(sentence)
        sentence = expand_plain_numbers(sentence, self.natural)
        return sentence


# ---------------------------------------------------------------------------
# N2gk+ additions (reference `:391-696`)
# ---------------------------------------------------------------------------

SPECIAL_SYMBOLS = {
    "％": "퍼센트", "%p": "퍼센트포인트", "% p": "퍼센트포인트",
    "&": "앤", "$": "달러", "#": "샵", "@": "앳",
    "+": "플러스", "-": "마이너스", "±": "플러스마이너스",
    "㎝": "cm", "㎜": "mm", "㎏": "kg", "㎖": "ml", "℃": "도",
    "～": "~", "ｍ": "m ", "㎞": "km", "㎎": "mg",
    "_x000D_": "", "㎡": "제곱미터", "㎥": "세제곱미터",
    "코로나 19": "코로나 일구", "코로나19": "코로나 일구",
    "%": "퍼센트",
}

REMOVED_CHARS = {
    "<": "", ">": "", "=": "", "[": "", "]": "",
    "《": "", "》": "", "△": "", "＞": "", "＜": "",
    "‘": "", "’": "", "`": "", "”": "", "●": "",
    "≪": "", "≫": "", "「": "", "」": "", "/": "",
    "·": " ", "…": "", "▷": "",
    "(": "", ")": "", "㈜": "", "�": "",
    "ú": "", "◆": "", "ㆍ": "", "\n": "",
    "×": "", "°": "", "±": "", "•": "", "™": "",
    "®": "", "©": "", '"': "",
}

LATIN_LETTER_NAMES = {
    "A": "에이", "B": "비", "C": "씨", "D": "디", "E": "이", "F": "에프",
    "G": "지", "H": "에이치", "I": "아이", "J": "제이", "K": "케이", "L": "엘",
    "M": "엠", "N": "엔", "O": "오", "P": "피", "Q": "큐", "R": "알",
    "S": "에스", "T": "티", "U": "유", "V": "브이", "W": "더블유",
    "X": "엑스", "Y": "와이", "Z": "지",
}

JAMO_LETTER_NAMES = {
    "ㄱ": "기역", "ㄴ": "니은", "ㄷ": "디귿", "ㄹ": "리을", "ㅁ": "미음",
    "ㅂ": "비읍", "ㅅ": "시옫", "ㅇ": "이응", "ㅈ": "지읃", "ㅊ": "치읃",
    "ㅋ": "키윽", "ㅌ": "티읃", "ㅍ": "피읍", "ㅎ": "히읃",
}

WORD_SPELLINGS = {
    "KM": "킬로미터", "MM": "밀리미터", "M": "미터", "CM": "센티미터",
    "KG": "킬로그램", "G": "그램", "MG": "밀리그램", "L": "리터",
    "ML": "밀리리터", "HA": "헥타르", "㎡": "제곱미터", "V": "볼트",
    "㎾": "키로와트",
    "RAM": "램", "LAN": "랜", "ME TOO": "미투", "KAI": "카이", "OPEC": "오펙",
    "NASA": "나사", "FIFA": "피파", "KIA": "기아",
}

HISTORY_EVENT_WORDS = ["사건", "혁명", "절", "전쟁", "선언", "운동",
                       "항쟁", "독립", "민주화", "진상", "정변", "군사"]


def strip_symbols(text: str, erase_in_parentheses: bool = True) -> str:
    if erase_in_parentheses:
        text = re.sub(r"\([^)]*\)", "", text)
    return text.translate(str.maketrans(REMOVED_CHARS))


def apply_symbol_spellings(text: str) -> str:
    for sym, repl in SPECIAL_SYMBOLS.items():
        text = re.sub(re.escape(sym), repl, text)
    return text


def spell_single_letters(text: str) -> str:
    text = re.sub(r"([a-zA-Z])([가-힣])", r"\1 \2", text)
    text = re.sub(r"([가-힣])([a-zA-Z])", r"\1 \2", text)
    return "".join(LATIN_LETTER_NAMES.get(c, c) for c in text)


def spell_bare_jamo(text: str) -> str:
    pat = "([" + re.escape("".join(JAMO_LETTER_NAMES)) + "]+)"
    return re.sub(pat, lambda m: "".join(JAMO_LETTER_NAMES.get(c, c) for c in m.group(0)), text)


def expand_history_events(text: str) -> str:
    """'5.18 민주화 운동' -> '오일팔 민주화 운동' when a history word follows."""
    unit_words = {u for units, _, _ in UNIT_TABLE for u in units}
    pat = re.compile(r"(?P<num>\d+(?:\.\d+)+)")

    def repl(m):
        tail = text[m.end():]
        for w in re.findall(r"\b(\S+?)\b", tail)[:3]:
            if any(w.startswith(u) for u in unit_words):
                return m.group("num")
            if any(h in w for h in HISTORY_EVENT_WORDS):
                return "".join(SINO_DIGITS[int(d)] for d in m.group("num") if d.isdigit())
        return m.group("num")

    return pat.sub(repl, text)


class N2gkPlus(N2gk):
    """N2gk plus symbol stripping, spellings and event dates (reference `:391-696`)."""

    def __call__(self, sentence: str) -> str:
        sentence = strip_symbols(sentence)
        sentence = apply_symbol_spellings(sentence)
        sentence = spell_bare_jamo(sentence)
        sentence = expand_history_events(sentence)
        sentence = super().__call__(sentence)
        sentence = spell_single_letters(sentence)
        return sentence


_n2gk_plus: N2gkPlus | None = None


def normalize_n2gk_plus(text: str, natural: bool = True) -> str:
    """Singleton N2gk+ entry point (reference `:688-696`)."""
    global _n2gk_plus
    if _n2gk_plus is None or _n2gk_plus.natural != natural:
        _n2gk_plus = N2gkPlus(natural=natural)
    return _n2gk_plus(text)
