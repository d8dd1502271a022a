"""Dataset ETL: corpus -> raw.arrow + duration.json + vocab.txt (counterpart
of korean_f5_tts_tpu/train/datasets/prepare.py).

A copy on the port's text/ and utils/audio.py, so both packages write the
same artefact triple from the same corpus; data/dataset.py:load_dataset reads
it. One parameterised pipeline: a corpus reader (csv, kss transcript, jsonl,
Emilia, LibriTTS, LJSpeech, WenetSpeech4TTS, CoreaSpeech) x a tokenizer mode
(the 13 modes of inference, text/vocab.py) x optional N2gk+ normalisation.
pyarrow is imported by the writer only.

    python -m korean_f5_tts_tpu_torch.train.datasets.prepare --corpus_root corpus \
        --dataset_name KSS --tokenizer kor_allophone --format kss
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from pathlib import Path

from korean_f5_tts_tpu_torch.text.korean import KOREAN_CONVERTERS
from korean_f5_tts_tpu_torch.text.normalization import normalize_n2gk_plus
from korean_f5_tts_tpu_torch.text.vocab import KOREAN_TOKENIZER_NAMES
from korean_f5_tts_tpu_torch.utils.audio import load_wav


# -- corpus readers ----------------------------------------------------------


def read_csv_corpus(root: str, metadata: str = "metadata.csv",
                    delimiter: str = "|") -> list[dict]:
    """metadata.csv rows `wav|text` with wavs under root/wavs (prepare_csv_wavs)."""
    rows = []
    path = os.path.join(root, metadata)
    with open(path, "r", encoding="utf-8-sig", newline="") as f:
        for rec in csv.reader(f, delimiter=delimiter):
            if len(rec) < 2:
                continue
            wav = rec[0] if rec[0].endswith(".wav") else rec[0] + ".wav"
            wav_path = os.path.join(root, "wavs", wav)
            if not os.path.exists(wav_path):
                wav_path = os.path.join(root, wav)
            rows.append({"audio_path": wav_path, "text": rec[1].strip()})
    return rows


def read_kss_corpus(root: str, transcript: str = "transcript.v.1.4.txt",
                    text_field: int = 2) -> list[dict]:
    """KSS transcript rows `path|orig|expanded|decomposed|en|duration`."""
    rows = []
    with open(os.path.join(root, transcript), "r", encoding="utf-8") as f:
        for line in f:
            rec = line.rstrip("\n").split("|")
            if len(rec) < 3:
                continue
            item = {"audio_path": os.path.join(root, rec[0]),
                    "text": rec[text_field].strip()}
            if len(rec) >= 6:
                try:
                    item["duration"] = float(rec[5])
                except ValueError:
                    pass
            rows.append(item)
    return rows


def read_jsonl_corpus(path: str, audio_key: str = "audio_path",
                      text_key: str = "text") -> list[dict]:
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            rows.append({"audio_path": d[audio_key], "text": d[text_key],
                         **({"duration": d["duration"]} if "duration" in d else {})})
    return rows


def repetition_found(text: str, length: int = 2, tolerance: int = 10) -> bool:
    """True if any length-n substring repeats more than `tolerance` times —
    the reference's synthetic/looped-audio text filter (utils.py:524-532)."""
    from collections import defaultdict

    counts: dict[str, int] = defaultdict(int)
    for i in range(len(text) - length + 1):
        counts[text[i: i + length]] += 1
    return any(c > tolerance for c in counts.values())


# Bad-utterance ID lists + character filters from the reference's Emilia ETL
# (prepare_emilia.py:24-109 — curated data, reproduced as the filter spec:
# known synthesized / heavily code-switched clips).
EMILIA_OUT_ZH = {
    "ZH_B00041_S06226", "ZH_B00042_S09204", "ZH_B00065_S09430",
    "ZH_B00065_S09431", "ZH_B00066_S09327", "ZH_B00066_S09328",
}
EMILIA_ZH_FILTERS = ["い", "て"]
EMILIA_OUT_EN = {
    "EN_B00013_S00913", "EN_B00042_S00120", "EN_B00055_S04111",
    "EN_B00061_S00693", "EN_B00061_S01494", "EN_B00061_S03375",
    "EN_B00059_S00092", "EN_B00111_S04300", "EN_B00100_S03759",
    "EN_B00087_S03811", "EN_B00059_S00950", "EN_B00089_S00946",
    "EN_B00078_S05127", "EN_B00070_S04089", "EN_B00074_S09659",
    "EN_B00061_S06983", "EN_B00061_S07060", "EN_B00059_S08397",
    "EN_B00082_S06192", "EN_B00091_S01238", "EN_B00089_S07349",
    "EN_B00070_S04343", "EN_B00061_S02400", "EN_B00076_S01262",
    "EN_B00068_S06467", "EN_B00076_S02943", "EN_B00064_S05954",
    "EN_B00061_S05386", "EN_B00066_S06544", "EN_B00076_S06944",
    "EN_B00072_S08620", "EN_B00076_S07135", "EN_B00076_S09127",
    "EN_B00065_S00497", "EN_B00059_S06227", "EN_B00063_S02859",
    "EN_B00075_S01547", "EN_B00061_S08286", "EN_B00079_S02901",
    "EN_B00092_S03643", "EN_B00096_S08653", "EN_B00063_S04297",
    "EN_B00063_S04614", "EN_B00079_S04698", "EN_B00104_S01666",
    "EN_B00061_S09504", "EN_B00061_S09694", "EN_B00065_S05444",
    "EN_B00063_S06860", "EN_B00065_S05725", "EN_B00069_S07628",
    "EN_B00083_S03875", "EN_B00071_S07665", "EN_B00062_S04187",
    "EN_B00065_S09873", "EN_B00065_S09922", "EN_B00084_S02463",
    "EN_B00067_S05066", "EN_B00106_S08060", "EN_B00073_S06399",
    "EN_B00073_S09236", "EN_B00087_S00432", "EN_B00085_S05618",
    "EN_B00064_S01262", "EN_B00072_S01739", "EN_B00059_S03913",
    "EN_B00069_S04036", "EN_B00067_S05623", "EN_B00060_S05389",
    "EN_B00060_S07290", "EN_B00062_S08995",
}
EMILIA_EN_FILTERS = ["ا", "い", "て"]


def _emilia_one_jsonl(jsonl_path: str) -> list[dict]:
    """One Emilia shard: filter bad IDs / foreign chars / repetition loops,
    normalize ZH punctuation (prepare_emilia.py:111-147)."""
    rows = []
    base = Path(jsonl_path).parent
    with open(jsonl_path, "r", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            text, lang = obj["text"], obj.get("language", "")
            utt_id = obj["wav"].split("/")[1] if "/" in obj["wav"] else obj["wav"]
            if lang == "zh":
                if (utt_id in EMILIA_OUT_ZH
                        or any(c in text for c in EMILIA_ZH_FILTERS)
                        or repetition_found(text)):
                    continue
                text = text.translate(str.maketrans({",": "，", "!": "！", "?": "？"}))
            elif lang == "en":
                if (utt_id in EMILIA_OUT_EN
                        or any(c in text for c in EMILIA_EN_FILTERS)
                        or repetition_found(text, length=4)):
                    continue
            rows.append({"audio_path": str(base / obj["wav"]), "text": text,
                         "duration": float(obj["duration"])})
    return rows


def read_emilia_corpus(root: str, langs: tuple[str, ...] = ("ZH", "EN"),
                       max_workers: int | None = None) -> list[dict]:
    """Emilia layout: root/{LANG}/*.jsonl shards next to their audio dirs;
    shards processed in parallel (prepare_emilia.py's ProcessPoolExecutor —
    threads here: the work is IO + small JSON, and one fork per shard on a
    single-core host is pure overhead)."""
    from concurrent.futures import ThreadPoolExecutor

    shards = []
    for lang in langs:
        lang_dir = Path(root) / lang
        if lang_dir.is_dir():
            shards.extend(sorted(str(p) for p in lang_dir.glob("*.jsonl")))
    rows: list[dict] = []
    with ThreadPoolExecutor(max_workers=max_workers or 4) as ex:
        for sub in ex.map(_emilia_one_jsonl, shards):
            rows.extend(sub)
    return rows


def read_libritts_corpus(root: str) -> list[dict]:
    """LibriTTS layout: walk for *.normalized.txt next to same-stem wavs
    (prepare_libritts.py role)."""
    rows = []
    for txt in sorted(Path(root).rglob("*.normalized.txt")):
        wav = txt.with_name(txt.name.replace(".normalized.txt", ".wav"))
        if wav.exists():
            rows.append({"audio_path": str(wav),
                         "text": txt.read_text(encoding="utf-8").strip()})
    return rows


def read_ljspeech_corpus(root: str) -> list[dict]:
    """LJSpeech metadata.csv `id|raw|normalized`, normalized column used
    (prepare_ljspeech.py role)."""
    rows = []
    with open(os.path.join(root, "metadata.csv"), "r", encoding="utf-8") as f:
        for line in f:
            rec = line.rstrip("\n").split("|")
            if len(rec) < 3:
                continue
            rows.append({"audio_path": os.path.join(root, "wavs", rec[0] + ".wav"),
                         "text": rec[2].strip()})
    return rows


def read_wenetspeech4tts_corpus(root: str) -> list[dict]:
    """WenetSpeech4TTS: {Premium,Standard,Basic}/*/wav_text pairs listed in
    .txt manifests `utt_path<TAB>text` (prepare_wenetspeech4tts.py role)."""
    rows = []
    for tier in ("Premium", "Standard", "Basic"):
        tier_dir = Path(root) / tier
        if not tier_dir.is_dir():
            continue
        for manifest in sorted(tier_dir.rglob("*.txt")):
            for line in manifest.read_text(encoding="utf-8").splitlines():
                parts = line.split("\t")
                if len(parts) < 2:
                    continue
                wav = parts[0] if parts[0].endswith(".wav") else parts[0] + ".wav"
                wav_path = Path(wav)
                if not wav_path.is_absolute():
                    wav_path = manifest.parent / wav
                rows.append({"audio_path": str(wav_path), "text": parts[1].strip()})
    return rows


def read_coreaspeech_corpus(root: str, metadata: str = "metadata_train.txt") -> list[dict]:
    """CoreaSpeech metadata rows `rel_path|text|norm|pronunciation`: the 4th
    column is a pre-G2P pronunciation string (prepare_coreaspeech_salt_n.py
    reads index 3). Rows keep BOTH the display text and the pronunciation so
    salt modes can decompose without g2p."""
    rows = []
    with open(os.path.join(root, metadata), "r", encoding="utf-8") as f:
        for line in f:
            rec = line.rstrip("\n").split("|")
            if len(rec) < 4:
                continue
            rows.append({"audio_path": os.path.join(root, rec[0]),
                         "text": rec[1].strip(),
                         "pronunciation": rec[3].strip()})
    return rows


READERS = {
    "csv": read_csv_corpus,
    "coreaspeech": read_coreaspeech_corpus,
    "kss": read_kss_corpus,
    "jsonl": read_jsonl_corpus,
    "emilia": read_emilia_corpus,
    "libritts": read_libritts_corpus,
    "ljspeech": read_ljspeech_corpus,
    "wenetspeech4tts": read_wenetspeech4tts_corpus,
}


# -- tokenization ------------------------------------------------------------


def tokenize_rows(rows: list[dict], tokenizer: str, use_n2gk_plus: bool = False,
                  use_skip_tc: bool = False, legacy: bool = False) -> list[dict]:
    """Attach `tokens` per row; `char`/`pinyin` keep the raw text."""
    from korean_f5_tts_tpu_torch.text.korean import PRONUNCIATION_CONVERTERS

    if tokenizer in PRONUNCIATION_CONVERTERS:
        # salt modes decompose the corpus's pre-G2P pronunciation column
        # (no g2p, no n2gk — the column is already pronounced text)
        texts = [r.get("pronunciation", r["text"]) for r in rows]
        token_lists = PRONUNCIATION_CONVERTERS[tokenizer](
            texts, use_skip_tc=use_skip_tc, legacy=legacy)
        out = []
        for row, toks in zip(rows, token_lists):
            r = dict(row)
            r["tokens"] = toks
            r["text"] = "".join(toks)
            out.append(r)
        return out
    texts = [r["text"] for r in rows]
    if use_n2gk_plus:
        texts = [normalize_n2gk_plus(t) for t in texts]
    if tokenizer in KOREAN_TOKENIZER_NAMES:
        from korean_f5_tts_tpu_torch.text.korean import (
            convert_char_to_allophone_skipTC,
            convert_char_to_grapheme_skipTC,
            convert_char_to_phoneme_skipTC,
        )

        if use_skip_tc and tokenizer == "kor_grapheme":
            token_lists = convert_char_to_grapheme_skipTC(texts, legacy=legacy)
        elif use_skip_tc and tokenizer == "kor_phoneme":
            token_lists = convert_char_to_phoneme_skipTC(texts, legacy=legacy)
        elif use_skip_tc and tokenizer == "kor_allophone":
            token_lists = convert_char_to_allophone_skipTC(texts, legacy=legacy)
        else:
            token_lists = KOREAN_CONVERTERS[tokenizer](texts)
    elif tokenizer == "char":
        token_lists = [list(t) for t in texts]
    elif tokenizer == "pinyin":
        from korean_f5_tts_tpu_torch.text.pinyin import convert_char_to_pinyin

        token_lists = convert_char_to_pinyin(texts)
    else:
        raise ValueError(f"unknown tokenizer {tokenizer}")
    out = []
    for row, toks in zip(rows, token_lists):
        r = dict(row)
        r["tokens"] = toks
        r["text"] = "".join(toks) if tokenizer not in ("char", "pinyin") else row["text"]
        out.append(r)
    return out


def build_vocab(token_rows: list[dict]) -> list[str]:
    """Unique tokens, space forced to index 0 (get_tokenizer contract)."""
    seen = set()
    for r in token_rows:
        seen.update(r["tokens"])
    seen.discard(" ")
    seen.discard("")
    return [" "] + sorted(seen)


# -- writer ------------------------------------------------------------------


def measure_durations(rows: list[dict]) -> list[float]:
    out = []
    for r in rows:
        if "duration" in r:
            out.append(float(r["duration"]))
        else:
            wav, sr = load_wav(r["audio_path"])
            out.append(wav.shape[-1] / sr)
    return out


def write_dataset(rows: list[dict], durations: list[float], out_dir: str,
                  vocab: list[str] | None = None) -> None:
    import pyarrow as pa

    os.makedirs(out_dir, exist_ok=True)
    table = pa.table({
        "audio_path": [r["audio_path"] for r in rows],
        "text": [r["text"] for r in rows],
        "duration": durations,
    })
    with pa.OSFile(os.path.join(out_dir, "raw.arrow"), "wb") as sink:
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
    with open(os.path.join(out_dir, "duration.json"), "w", encoding="utf-8") as f:
        json.dump({"duration": durations}, f)
    if vocab is not None:
        with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            f.writelines(v + "\n" for v in vocab)


def prepare(
    corpus_root: str,
    dataset_name: str,
    tokenizer: str,
    corpus_format: str = "csv",
    use_n2gk_plus: bool = False,
    use_skip_tc: bool = False,
    legacy: bool = False,
    data_dir: str | None = None,
    pretrained_vocab: str | None = None,
    max_rows: int | None = None,
    subset_hours: float | None = None,
) -> str:
    """Full pipeline; returns the output dir data/{name}_{tokenizer}."""
    data_dir = data_dir or os.environ.get("F5_TTS_DATA_DIR", "data")
    rows = READERS[corpus_format](corpus_root)
    if max_rows:
        rows = rows[:max_rows]
    token_rows = tokenize_rows(rows, tokenizer, use_n2gk_plus=use_n2gk_plus,
                               use_skip_tc=use_skip_tc, legacy=legacy)
    durations = measure_durations(token_rows)
    if subset_hours is not None:
        token_rows, durations = subset_by_hours(token_rows, durations, subset_hours)
    if pretrained_vocab:
        # finetune flow: reuse (and verify coverage of) an existing vocab
        existing = [line.rstrip("\n") for line in
                    open(pretrained_vocab, "r", encoding="utf-8")]
        missing = sorted(
            {t for r in token_rows for t in r["tokens"]} - set(existing) - {""}
        )
        if missing:
            print(f"warning: {len(missing)} tokens missing from pretrained vocab: "
                  f"{missing[:20]}")
        vocab = existing
    else:
        vocab = build_vocab(token_rows)
    out_dir = os.path.join(data_dir, f"{dataset_name}_{tokenizer}")
    write_dataset(token_rows, durations, out_dir, vocab)
    print(f"{out_dir}: {len(token_rows)} rows, {sum(durations) / 3600:.2f} h, "
          f"vocab {len(vocab)}")
    return out_dir


def subset_by_hours(rows: list[dict], durations: list[float],
                    hours: float, seed: int = 666) -> tuple[list[dict], list[float]]:
    """Deterministic fixed-hour subset (split_kss_metadata.py role: build
    1h/3h/5h ablation splits)."""
    import numpy as np

    order = np.random.default_rng(seed).permutation(len(rows))
    out_rows, out_durs, acc = [], [], 0.0
    for i in order:
        if acc >= hours * 3600:
            break
        out_rows.append(rows[i])
        out_durs.append(durations[i])
        acc += durations[i]
    return out_rows, out_durs


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.train.datasets.prepare")
    p.add_argument("--corpus_root", required=True)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--tokenizer", required=True,
                   help="char | pinyin | " + " | ".join(KOREAN_TOKENIZER_NAMES))
    p.add_argument("--format", default="csv", choices=sorted(READERS))
    p.add_argument("--n2gk_plus", action="store_true")
    p.add_argument("--skip_tc", action="store_true")
    p.add_argument("--legacy", action="store_true")
    p.add_argument("--pretrained_vocab", default=None)
    p.add_argument("--max_rows", type=int, default=None)
    p.add_argument("--subset_hours", type=float, default=None,
                   help="keep a deterministic N-hour subset (1h/3h/5h ablations)")
    args = p.parse_args(argv)
    prepare(args.corpus_root, args.dataset_name, args.tokenizer,
            corpus_format=args.format, use_n2gk_plus=args.n2gk_plus,
            use_skip_tc=args.skip_tc, legacy=args.legacy,
            pretrained_vocab=args.pretrained_vocab, max_rows=args.max_rows,
            subset_hours=args.subset_hours)


if __name__ == "__main__":
    main()
