from korean_f5_tts_tpu_torch.text.g2p_ko import G2pKo, g2p
from korean_f5_tts_tpu_torch.text.korean import (
    KOREAN_CONVERTERS,
    convert_char_to_allophone,
    convert_char_to_allophone_skipTC,
    convert_char_to_grapheme,
    convert_char_to_grapheme_skipTC,
    convert_char_to_no_ieung_g2p,
    convert_char_to_no_ieung_raw,
    convert_char_to_phoneme,
    convert_char_to_phoneme_skipTC,
)
from korean_f5_tts_tpu_torch.text.normalization import N2gk, N2gkPlus, normalize_n2gk_plus
from korean_f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin
from korean_f5_tts_tpu_torch.text.vocab import (
    detect_tokenizer_type,
    get_tokenizer,
    list_str_to_idx,
    list_str_to_tensor,
    load_vocab_file,
    tokenize_text,
)

__all__ = [
    "G2pKo",
    "g2p",
    "KOREAN_CONVERTERS",
    "convert_char_to_allophone",
    "convert_char_to_allophone_skipTC",
    "convert_char_to_grapheme",
    "convert_char_to_grapheme_skipTC",
    "convert_char_to_no_ieung_g2p",
    "convert_char_to_no_ieung_raw",
    "convert_char_to_phoneme",
    "convert_char_to_phoneme_skipTC",
    "N2gk",
    "N2gkPlus",
    "normalize_n2gk_plus",
    "convert_char_to_pinyin",
    "detect_tokenizer_type",
    "get_tokenizer",
    "list_str_to_idx",
    "list_str_to_tensor",
    "load_vocab_file",
    "tokenize_text",
]
