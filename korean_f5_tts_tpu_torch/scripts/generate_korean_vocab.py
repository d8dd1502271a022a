"""Generate Korean tokenizer vocab files from the jamo/allophone constants
(a copy of korean_f5_tts_tpu/scripts/generate_korean_vocab.py over the
port's text/jamo.py and text/korean.py).

Parity with reference `src/f5_tts/scripts/generate_korean_vocab.py`: builds
vocab.txt for each Korean tokenizer mode from the constant tables (no corpus
needed), space at index 0, punctuation tail shared with the pinyin vocabs.
"""

from __future__ import annotations

import argparse
import os

from korean_f5_tts_tpu_torch.text.jamo import CHOSEONG, JONGSEONG, JUNGSEONG
from korean_f5_tts_tpu_torch.text.korean import (
    MARK_CODA,
    MARK_INIT,
    MARK_PAL,
    PHONEMES_C,
    PHONEMES_C_SONORANT,
    PHONEMES_I,
    PHONEMES_I_NO_H,
    PHONEMES_N,
    PHONEMES_P,
    SKIPTC_TOKEN,
)

PUNCTUATION = list(".,!?;:'\"()-~… ")


def base_jamo() -> list[str]:
    out = list(dict.fromkeys(CHOSEONG + JUNGSEONG + [j for j in JONGSEONG if j]))
    return out


def vocab_for_mode(mode: str, skip_tc: bool = False) -> list[str]:
    toks = base_jamo()
    if mode == "kor_grapheme":
        pass
    elif mode == "kor_phoneme":
        pass
    elif mode in ("kor_allophone", "kor_i_only", "kor_c_only", "kor_i_and_c",
                  "kor_n_only", "kor_i_and_n", "kor_inf", "kor_nf",
                  "kor_efficient_allophone"):
        init_set = {
            "kor_allophone": PHONEMES_I, "kor_i_only": PHONEMES_I,
            "kor_i_and_c": PHONEMES_I, "kor_i_and_n": PHONEMES_I,
            "kor_inf": PHONEMES_I, "kor_efficient_allophone": PHONEMES_I_NO_H,
        }.get(mode, [])
        coda_set = {
            "kor_allophone": PHONEMES_C, "kor_c_only": PHONEMES_C,
            "kor_i_and_c": PHONEMES_C, "kor_n_only": PHONEMES_N,
            "kor_i_and_n": PHONEMES_N, "kor_inf": PHONEMES_C_SONORANT,
            "kor_nf": PHONEMES_C_SONORANT,
            "kor_efficient_allophone": PHONEMES_C_SONORANT,
        }.get(mode, [])
        toks += [c + MARK_INIT for c in init_set]
        toks += [c + MARK_CODA for c in coda_set]
        if mode == "kor_allophone":
            toks += [c + MARK_PAL for c in PHONEMES_P]
    elif mode in ("kor_no_ieung_g2p", "kor_no_ieung_raw"):
        pass
    else:
        raise ValueError(mode)
    if skip_tc:
        toks.append(SKIPTC_TOKEN)
    seen = dict.fromkeys(toks)
    seen.pop(" ", None)
    return [" "] + list(seen) + [p for p in PUNCTUATION if p != " "]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="data/vocabs")
    p.add_argument("--skip_tc", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    modes = ["kor_grapheme", "kor_phoneme", "kor_allophone", "kor_i_only",
             "kor_c_only", "kor_i_and_c", "kor_n_only", "kor_i_and_n",
             "kor_inf", "kor_nf", "kor_efficient_allophone",
             "kor_no_ieung_g2p", "kor_no_ieung_raw"]
    for mode in modes:
        vocab = vocab_for_mode(mode, skip_tc=args.skip_tc)
        path = os.path.join(args.out_dir, f"vocab_{mode}.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.writelines(t + "\n" for t in vocab)
        print(f"{path}: {len(vocab)} tokens")


if __name__ == "__main__":
    main()
