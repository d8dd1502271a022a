"""Standard-Korean grapheme-to-phoneme (G2P) engine, pure Python.

The reference delegates G2P to the external `g2pk2` package
(`src/f5_tts/model/utils.py:153-199`). That package is not vendorable here, so
this module implements the standard pronunciation rules (표준 발음법) from
scratch as an ordered rule pipeline over decomposed jamo:

  1. lexical exceptions (맛있다/멋있다 …)
  2. palatalization      구개음화   (굳이→구지, 같이→가치, 닫히다→다치다)
  3. ㅎ-cluster rules     격음화/ㅎ탈락 (놓고→노코, 많다→만타, 낳은→나은, 놓는→논는)
  4. onset-ㅎ aspiration  (축하→추카, 입학→이팍, 앉히다→안치다)
  5. liaison             연음       (옷이→오시, 값이→갑씨, 닭을→달글)
  6. coda neutralization + cluster simplification (부엌→부억, 값→갑, 맑게→말께)
  7. tensification       경음화     (국밥→국빱, 앉다→안따)
  8. liquidization       유음화     (신라→실라, 칼날→칼랄)
  9. nasalization        비음화     (국물→궁물, 독립→동닙, 담력→담녁)
 10. vowel adjustments   (희망→히망, 가져→가저)

Output is a hangul string (pronunciation spelling), same contract as
`g2pk2.G2p.__call__`. Eojeol (whitespace) boundaries block all sandhi rules,
matching how the reference splits pronunciations back into eojeols
(`model/utils.py:201-205`).
"""

from __future__ import annotations

import re

from korean_f5_tts_tpu_torch.text.jamo import compose, decompose, is_hangul_syllable

# -- rule tables -------------------------------------------------------------

# coda neutralization (평파열음화 + 자음군 단순화) when not resyllabified
_CODA_NEUTRAL = {
    "ㄱ": "ㄱ", "ㄲ": "ㄱ", "ㅋ": "ㄱ", "ㄳ": "ㄱ", "ㄺ": "ㄱ",
    "ㄴ": "ㄴ", "ㄵ": "ㄴ", "ㄶ": "ㄴ",
    "ㄷ": "ㄷ", "ㅅ": "ㄷ", "ㅆ": "ㄷ", "ㅈ": "ㄷ", "ㅊ": "ㄷ", "ㅌ": "ㄷ", "ㅎ": "ㄷ",
    "ㄹ": "ㄹ", "ㄼ": "ㄹ", "ㄽ": "ㄹ", "ㄾ": "ㄹ", "ㅀ": "ㄹ",
    "ㅁ": "ㅁ", "ㄻ": "ㅁ",
    "ㅂ": "ㅂ", "ㅍ": "ㅂ", "ㅄ": "ㅂ", "ㄿ": "ㅂ",
    "ㅇ": "ㅇ", "": "",
}

# complex coda split for liaison: coda -> (remaining coda, migrated onset)
_CODA_SPLIT = {
    "ㄳ": ("ㄱ", "ㅆ"), "ㄵ": ("ㄴ", "ㅈ"), "ㄺ": ("ㄹ", "ㄱ"), "ㄻ": ("ㄹ", "ㅁ"),
    "ㄼ": ("ㄹ", "ㅂ"), "ㄽ": ("ㄹ", "ㅆ"), "ㄾ": ("ㄹ", "ㅌ"), "ㄿ": ("ㄹ", "ㅍ"),
    "ㅄ": ("ㅂ", "ㅆ"),
}

_TENSE = {"ㄱ": "ㄲ", "ㄷ": "ㄸ", "ㅂ": "ㅃ", "ㅅ": "ㅆ", "ㅈ": "ㅉ"}
_ASPIRATE = {"ㄱ": "ㅋ", "ㄷ": "ㅌ", "ㅂ": "ㅍ", "ㅈ": "ㅊ"}

# coda + onset-ㅎ -> (new coda, new aspirated onset)
_CODA_H_ASPIRATE = {
    "ㄱ": ("", "ㅋ"), "ㄲ": ("", "ㅋ"), "ㅋ": ("", "ㅋ"), "ㄺ": ("ㄹ", "ㅋ"),
    "ㄷ": ("", "ㅌ"), "ㅅ": ("", "ㅌ"), "ㅆ": ("", "ㅌ"), "ㅌ": ("", "ㅌ"),
    "ㅈ": ("", "ㅊ"), "ㅊ": ("", "ㅊ"), "ㄵ": ("ㄴ", "ㅊ"),
    "ㅂ": ("", "ㅍ"), "ㅍ": ("", "ㅍ"), "ㄼ": ("ㄹ", "ㅍ"), "ㅄ": ("ㅂ", "ㅍ"),
}

# coda containing ㅎ: (reduced coda, set of onsets it aspirates)
_H_CODAS = {"ㅎ": "", "ㄶ": "ㄴ", "ㅀ": "ㄹ"}

# verb-stem sonorant-cluster tensification triggers (표준발음법 24/25항)
_SONORANT_TENSE_CODAS = {"ㄵ", "ㄻ", "ㄼ", "ㄾ"}

_Y_TO_PLAIN = {"ㅑ": "ㅏ", "ㅒ": "ㅐ", "ㅕ": "ㅓ", "ㅖ": "ㅔ", "ㅛ": "ㅗ", "ㅠ": "ㅜ"}

# lexical pronunciation exceptions applied on the raw string, in order
# (longest-first where prefixes overlap). Three classes a lexicon-free rule
# engine cannot derive:
#   - ㄴ-insertion compounds (표준발음법 29항 — needs morpheme boundaries);
#     entries insert the ㄴ and let the regular 비음화/유음화 rules finish
#   - 유음화 blockers ㄴ+ㄹ -> ㄴㄴ (20항 다만)
#   - Sino-Korean ㄹ-coda tensification (26항 — needs hanja knowledge)
_EXCEPTIONS = [
    ("맛있", "마싯"),
    ("멋있", "머싯"),
    ("맛없", "마덥"),  # 15항: 받침 + 실질형태소 모음 (맛없다[마덥따])
    ("멋없", "머덥"),
    ("넓죽", "넙죽"),
    ("넓둥", "넙둥"),
    # -- 15항: 받침 + 실질형태소 모음은 대표음으로 연음 ---------------------
    ("겉옷", "거돗"),
    ("헛웃음", "허두슴"),
    ("웃어른", "우더른"),
    ("값어치", "가버치"),
    ("짓이기", "진니기"),  # + 29항 ㄴ첨가
    # -- 29항 ㄴ첨가 compounds --------------------------------------------
    ("꽃잎", "꼰닢"),
    ("나뭇잎", "나문닢"),
    ("솜이불", "솜니불"),
    ("홑이불", "홑니불"),
    ("색연필", "색년필"),
    ("한여름", "한녀름"),
    ("식용유", "시굥뉴"),
    ("알약", "알냑"),  # ㄴ-insert then 유음화 -> 알략
    ("물약", "물냑"),
    ("담요", "담뇨"),
    ("맨입", "맨닙"),
    ("늑막염", "늑막념"),
    ("콩엿", "콩녓"),
    ("막일", "막닐"),
    ("삯일", "삯닐"),
    ("내복약", "내복냑"),
    ("남존여비", "남존녀비"),
    ("신여성", "신녀성"),
    ("직행열차", "직행녈차"),
    ("눈요기", "눈뇨기"),
    ("영업용", "영업뇽"),
    ("국민윤리", "국민뉸리"),
    ("들일", "들닐"),
    ("솔잎", "솔닢"),
    ("설익", "설닉"),
    ("불여우", "불녀우"),
    ("서울역", "서울녁"),
    ("물엿", "물녓"),
    ("휘발유", "휘발뉴"),
    ("유들유들", "유들뉴들"),
    ("한입", "한닙"),
    ("콩잎", "콩닢"),
    ("깻잎", "깬닢"),
    ("첫여름", "첟녀름"),
    ("풀잎", "풀닢"),
    ("두통약", "두통냑"),
    ("눈약", "눈냑"),
    ("밭일", "받닐"),
    ("부엌일", "부억닐"),
    ("앞일", "압닐"),
    ("옛일", "옌닐"),
    ("헛일", "헌닐"),
    # -- 20항 다만: ㄴ+ㄹ -> ㄴㄴ (유음화 blocked) --------------------------
    ("의견란", "의견난"),
    ("임진란", "임진난"),
    ("생산량", "생산냥"),
    ("결단력", "결딴녁"),  # + 26항 tensification
    ("공권력", "공꿘녁"),
    ("상견례", "상견녜"),
    ("횡단로", "횡단노"),
    ("이원론", "이원논"),
    ("입원료", "이붠뇨"),
    ("구근류", "구근뉴"),
    # -- 26항: 한자어 ㄹ받침 + ㄷ/ㅅ/ㅈ 경음화 (common lexemes) -------------
    ("갈등", "갈뜽"),
    ("발동", "발똥"),
    ("절도", "절또"),
    ("말살", "말쌀"),
    ("불소", "불쏘"),
    ("일시", "일씨"),
    ("갈증", "갈쯩"),
    ("물질", "물찔"),
    ("발전", "발쩐"),
    ("몰상식", "몰쌍식"),
    ("불세출", "불쎄출"),
    ("결단", "결딴"),
    ("발달", "발딸"),
    ("팔도", "팔또"),
    ("설득", "설뜩"),
    ("철저", "철쩌"),
    ("실수", "실쑤"),
    ("열정", "열쩡"),
    ("일정", "일쩡"),
    ("출장", "출짱"),
    ("결정", "결쩡"),
    ("밀도", "밀또"),
    ("솔직", "솔찍"),
    ("발생", "발쌩"),
    ("결석", "결썩"),
    ("출석", "출썩"),
    ("발상", "발쌍"),
    ("일단", "일딴"),
    ("발사", "발싸"),
    ("발주", "발쭈"),
    ("활동", "활똥"),
    ("열등", "열뜽"),
    ("달성", "달썽"),
    # lexical 한자어 경음화 beyond ㄹ-coda (사건[사껀], -성 after ㄴ/ㅇ)
    ("사건", "사껀"),
    ("가능성", "가능썽"),
    ("안정성", "안정썽"),
    ("정체성", "정체썽"),
    # -- 28항: 관형격 기능 합성어 경음화 (regulation's own examples + a few
    #    high-frequency compounds; needs compound-boundary knowledge in
    #    general — lexicalized here) ----------------------------------------
    ("문고리", "문꼬리"),
    ("눈동자", "눈똥자"),
    ("신바람", "신빠람"),
    ("산새", "산쌔"),
    ("손재주", "손째주"),
    ("길가", "길까"),
    ("물동이", "물똥이"),
    ("발바닥", "발빠닥"),
    ("굴속", "굴쏙"),
    ("술잔", "술짠"),
    ("바람결", "바람껼"),
    ("그믐달", "그믐딸"),
    ("아침밥", "아침빱"),
    ("강가", "강까"),
    ("초승달", "초승딸"),
    ("등불", "등뿔"),
    ("창살", "창쌀"),
    ("강줄기", "강쭐기"),
    ("보름달", "보름딸"),
    ("말솜씨", "말쏨씨"),
    ("물가", "물까"),
    ("밤길", "밤낄"),
    ("손등", "손뜽"),
    ("눈빛", "눈삗"),
    ("물살", "물쌀"),
    ("봄바람", "봄빠람"),
]

# ㄺ-final VERB stems: 어간 말음 ㄺ은 ㄱ 앞에서 [ㄹ] (11항 다만 — verbs only;
# nouns keep [ㄱ]: 흙과[흑꽈] vs 맑게[말께])
_LG_VERB_STEM_SYLLABLES = {"맑", "묽", "얽", "늙", "밝", "굵", "낡", "붉", "갉", "긁", "읽"}

# 24항: VERB stems ending in ㄴ/ㅁ tense a following plain onset (신고[신꼬],
# 안다[안따], 감고[감꼬]). POS-dependent in general (noun 신고(申告)[신고]);
# approximated with a high-frequency unambiguous stem list + ending whitelist,
# applied only when the ending closes the eojeol (so noun compounds like
# 신고했다 / 신고서 stay plain). 피동/사동 -기- is exempt per the 다만 clause
# (안기다/감기다[감기다]), so 기 is never in the ending list.
_VERB_NM_STEMS = {"신", "안", "감", "담", "넘", "남", "삼", "참", "품", "숨",
                  "심", "검", "더듬", "다듬", "머금", "서슴"}
_VERB_TENSE_ENDINGS = {"고", "게", "다", "지", "자", "던", "소"}
# 24항 다만: 사동 접미사 -기- (굶기다[굼기다], 옮기다[옴기다]) — these ㄻ-stem
# causatives must NOT ride the ㄵ/ㄻ/ㄼ/ㄾ cluster tensification below
_LM_CAUSATIVE_SYLLABLES = {"굶", "옮"}


def _split_eojeols(text: str) -> list[str]:
    """Split keeping separators so the original spacing is reconstructed."""
    return re.split(r"(\s+)", text)


class _Syl:
    __slots__ = ("cho", "jung", "jong")

    def __init__(self, cho: str, jung: str, jong: str):
        self.cho, self.jung, self.jong = cho, jung, jong


def _decompose_eojeol(eojeol: str) -> list[_Syl | str]:
    return [_Syl(*decompose(ch)) if is_hangul_syllable(ch) else ch for ch in eojeol]


def _adjacent_pairs(items: list) -> list[tuple[int, int]]:
    """Indices of adjacent hangul syllable pairs (non-hangul blocks sandhi)."""
    out = []
    for i in range(len(items) - 1):
        if isinstance(items[i], _Syl) and isinstance(items[i + 1], _Syl):
            out.append((i, i + 1))
    return out


def _apply_palatalization(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if b.jung != "ㅣ":
            continue
        if b.cho == "ㅇ":
            if a.jong == "ㄷ":
                a.jong, b.cho = "", "ㅈ"
            elif a.jong == "ㅌ":
                a.jong, b.cho = "", "ㅊ"
            elif a.jong == "ㄾ":
                a.jong, b.cho = "ㄹ", "ㅊ"
        elif b.cho == "ㅎ" and a.jong in ("ㄷ", "ㅌ"):
            # 닫히다→다치다, 묻히다→무치다
            a.jong, b.cho = "", "ㅊ"


def _apply_h_coda_rules(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if a.jong not in _H_CODAS:
            continue
        reduced = _H_CODAS[a.jong]
        if b.cho in _ASPIRATE:
            a.jong, b.cho = reduced, _ASPIRATE[b.cho]
        elif b.cho == "ㅅ":
            a.jong, b.cho = reduced, "ㅆ"
        elif b.cho == "ㄴ":
            a.jong = reduced if reduced else "ㄴ"  # 놓는→논는, 않네→안네, 앓네→알레(유음화 later)
        elif b.cho == "ㅇ":
            if reduced:  # ㄶ/ㅀ: 많아→마나, 싫어→시러
                a.jong, b.cho = "", reduced
            else:  # ㅎ 탈락: 낳은→나은
                a.jong = ""


def _apply_onset_h_aspiration(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if b.cho == "ㅎ" and a.jong in _CODA_H_ASPIRATE:
            a.jong, b.cho = _CODA_H_ASPIRATE[a.jong]


def _apply_liaison(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if b.cho != "ㅇ" or not a.jong:
            continue
        if a.jong == "ㅇ":  # ㅇ coda never resyllabifies
            continue
        if a.jong in _CODA_SPLIT:
            a.jong, b.cho = _CODA_SPLIT[a.jong]
        else:
            b.cho = a.jong
            a.jong = ""


def _apply_coda_neutralization(syls: list) -> None:
    for idx, s in enumerate(syls):
        if not isinstance(s, _Syl) or not s.jong:
            continue
        nxt = syls[idx + 1] if idx + 1 < len(syls) else None
        # 11항 다만 — 맑게→말께: VERB-stem ㄺ + ㄱ-onset keeps ㄹ (onset
        # already tensed to ㄲ); nouns neutralize to ㄱ (흙과→흑꽈)
        if (s.jong == "ㄺ" and isinstance(nxt, _Syl) and nxt.cho in ("ㄱ", "ㄲ")
                and compose(s.cho, s.jung, "ㄺ") in _LG_VERB_STEM_SYLLABLES):
            s.jong = "ㄹ"
            continue
        s.jong = _CODA_NEUTRAL.get(s.jong, s.jong)


def _apply_tensification(syls: list) -> None:
    # Runs BEFORE coda neutralization so cluster codas (ㄵ, ㄺ, ㄼ …) are still
    # distinguishable: 앉다→안따 needs ㄵ, 맑게→말께 needs ㄺ.
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if b.cho not in _TENSE:
            continue
        neutral = _CODA_NEUTRAL.get(a.jong, a.jong)
        if a.jong in _SONORANT_TENSE_CODAS:
            # 24항 다만: ㄻ-stem causatives in -기- stay plain (굶기다[굼기다])
            if (compose(a.cho, a.jung, a.jong) in _LM_CAUSATIVE_SYLLABLES
                    and b.cho == "ㄱ" and b.jung == "ㅣ" and not b.jong):
                continue
            if b.cho in ("ㄱ", "ㄷ", "ㅅ", "ㅈ"):
                b.cho = _TENSE[b.cho]
        elif neutral in ("ㄱ", "ㄷ", "ㅂ") and a.jong != "ㅎ":
            b.cho = _TENSE[b.cho]


def _apply_verb_nm_tensification(syls: list) -> None:
    """24항 heuristic: known ㄴ/ㅁ-final verb stems tense a following plain
    ending when that ending closes the eojeol (신고[신꼬], 감고[감꼬]) or is
    -습(니다) (참습니다[참씀니다]). See _VERB_NM_STEMS for limitations."""
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if a.jong not in ("ㄴ", "ㅁ") or b.cho not in _TENSE:
            continue
        stem = compose(a.cho, a.jung, a.jong)
        two = (compose(syls[i - 1].cho, syls[i - 1].jung, syls[i - 1].jong) + stem
               if i > 0 and isinstance(syls[i - 1], _Syl) else "")
        if stem not in _VERB_NM_STEMS and two not in _VERB_NM_STEMS:
            continue
        ending = compose(b.cho, b.jung, b.jong)
        is_last = j == len(syls) - 1 or not isinstance(syls[j + 1], _Syl)
        if ending in _VERB_TENSE_ENDINGS and is_last:
            b.cho = _TENSE[b.cho]
        elif (b.cho == "ㅅ" and b.jung == "ㅡ" and b.jong == "ㅂ"
              and not is_last and syls[j + 1].cho == "ㄴ"):
            b.cho = "ㅆ"  # -습니다


def _apply_balb_coda(syls: list) -> None:
    """10항 다만: 밟- is [밥] before a consonant (밟다[밥따], 밟는[밤는]) but
    keeps ㄼ liaison before vowels (밟아[발바])."""
    for i, s in enumerate(syls):
        if not isinstance(s, _Syl) or (s.cho, s.jung, s.jong) != ("ㅂ", "ㅏ", "ㄼ"):
            continue
        nxt = syls[i + 1] if i + 1 < len(syls) else None
        if not isinstance(nxt, _Syl) or nxt.cho != "ㅇ":
            s.jong = "ㅂ"


def _apply_liquidization(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        if a.jong == "ㄴ" and b.cho == "ㄹ":
            a.jong = "ㄹ"
        elif a.jong in ("ㄹ", "ㅀ", "ㄾ") and b.cho == "ㄴ":
            b.cho = "ㄹ"


def _apply_nasalization(syls: list) -> None:
    for i, j in _adjacent_pairs(syls):
        a, b = syls[i], syls[j]
        # ㄹ-onset weakening: 담력→담녁, 독립→(동닙 via next rule)
        if b.cho == "ㄹ" and a.jong in ("ㅁ", "ㅇ", "ㄱ", "ㄷ", "ㅂ"):
            b.cho = "ㄴ"
        if b.cho in ("ㄴ", "ㅁ"):
            if a.jong == "ㄱ":
                a.jong = "ㅇ"
            elif a.jong == "ㄷ":
                a.jong = "ㄴ"
            elif a.jong == "ㅂ":
                a.jong = "ㅁ"


def _apply_vowel_rules(syls: list) -> None:
    for s in syls:
        if not isinstance(s, _Syl):
            continue
        # 자음 + ㅢ → ㅣ (희망→히망); mandatory per 표준발음법 5항 다만3
        if s.jung == "ㅢ" and s.cho != "ㅇ":
            s.jung = "ㅣ"
        # ㅈ/ㅉ/ㅊ lose the y-glide (가져→가저, 쪄→쩌, 다쳐→다처)
        if s.cho in ("ㅈ", "ㅉ", "ㅊ") and s.jung in _Y_TO_PLAIN:
            s.jung = _Y_TO_PLAIN[s.jung]


_RULES = [
    _apply_balb_coda,
    _apply_verb_nm_tensification,
    _apply_palatalization,
    _apply_h_coda_rules,
    _apply_onset_h_aspiration,
    _apply_liaison,
    _apply_tensification,
    _apply_coda_neutralization,
    _apply_liquidization,
    _apply_nasalization,
    _apply_vowel_rules,
]


def g2p(text: str) -> str:
    """Text -> pronunciation string (hangul respelling), g2pk2-style contract."""
    for src, dst in _EXCEPTIONS:
        text = text.replace(src, dst)
    out_parts = []
    for part in _split_eojeols(text):
        if not part or part.isspace():
            out_parts.append(part)
            continue
        syls = _decompose_eojeol(part)
        for rule in _RULES:
            rule(syls)
        out_parts.append(
            "".join(compose(s.cho, s.jung, s.jong) if isinstance(s, _Syl) else s for s in syls)
        )
    return "".join(out_parts)


class G2pKo:
    """Callable wrapper mirroring `g2pk2.G2p` usage in the reference."""

    def __call__(self, text: str) -> str:
        return g2p(text)
