"""Token n-gram distribution analysis: Gini / Shannon / Rényi / efficiency
(a copy of korean_f5_tts_tpu/scripts/analyze_ngram_dist.py: numpy and
pyarrow only).

Role parity with reference `scripts/analyze_ngram_dist.py` (per-dataset
1/2/3-gram concentration metrics used to compare tokenizer designs) and
`scripts/analyze_all_ngrams.py` (the multi-dataset summary table). The
reference's research question: which Korean tokenizer mode yields the
flattest (most learnable) token distribution.

Metrics (analyze_ngram_dist.py:12-46 definitions):
  - Gini coefficient over n-gram frequencies (0 = uniform, 1 = concentrated)
  - Shannon entropy (bits)
  - Rényi entropy at alpha=2.5 (the repo's analysis convention)
  - efficiency = Rényi / log2(vocab)
"""

from __future__ import annotations

import argparse
import json
import math
import os
from collections import Counter
from typing import Iterable, Sequence

import numpy as np


def gini(counts: Counter) -> float:
    if not counts:
        return 0.0
    arr = np.sort(np.asarray(list(counts.values()), dtype=np.float64))
    n = arr.size
    index = np.arange(1, n + 1)
    return float(((2 * index - n - 1) * arr).sum() / (n * arr.sum()))


def renyi_entropy(counts: Counter, alpha: float = 2.5) -> float:
    total = sum(counts.values())
    if total == 0:
        return 0.0
    probs = np.asarray([c / total for c in counts.values()], dtype=np.float64)
    if alpha == 1.0:
        return float(-np.sum(probs * np.log2(probs + 1e-10)))
    return float((1.0 / (1.0 - alpha)) * np.log2(np.sum(probs ** alpha)))


def shannon_entropy(counts: Counter) -> float:
    return renyi_entropy(counts, alpha=1.0)


def ngrams(tokens: Sequence, n: int) -> list[tuple]:
    if len(tokens) < n:
        return []
    return [tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1)]


# tokens the reference analysis excludes: whitespace, punctuation, dataset
# annotation artifacts (analyze_ngram_dist.py:84)
IGNORED_TOKENS = {" ", ".", ",", "?", "!", "~", "…", "waiting...", "unintelligible"}


def ngram_stats(token_rows: Iterable[Sequence], orders: Sequence[int] = (1, 2, 3),
                alpha: float = 2.5) -> dict[int, dict]:
    counters = {n: Counter() for n in orders}
    for tokens in token_rows:
        filtered = [t for t in tokens
                    if t not in IGNORED_TOKENS and str(t).strip()]
        if not filtered:
            continue
        for n in orders:
            counters[n].update(ngrams(filtered, n) if n > 1 else filtered)
    out = {}
    for n in orders:
        c = counters[n]
        vocab = len(c)
        max_ent = math.log2(vocab) if vocab > 0 else 1.0
        ren = renyi_entropy(c, alpha=alpha)
        out[n] = {
            "vocab": vocab,
            "count": sum(c.values()),
            "gini": gini(c),
            "shannon": shannon_entropy(c),
            "renyi": ren,
            "eff": ren / max_ent if max_ent > 0 else 0.0,
            "top": c.most_common(5),
        }
    return out


def _rows_from_arrow(dataset_dir: str) -> list[list[str]]:
    import pyarrow as pa

    path = os.path.join(dataset_dir, "raw.arrow")
    try:
        with pa.memory_map(path) as src:
            table = pa.ipc.open_stream(src).read_all()
    except pa.ArrowInvalid:
        with pa.memory_map(path) as src:
            table = pa.ipc.open_file(src).read_all()
    col = table.column("text").to_pylist()
    # text may be a token list (reference ETL) or a joined string (ours)
    return [t if isinstance(t, list) else list(t) for t in col]


def analyze_dataset(dataset_name: str, data_root: str | None = None,
                    silent: bool = False) -> dict[int, dict] | None:
    data_root = data_root or os.environ.get("F5_TTS_DATA_DIR", "data")
    dataset_dir = os.path.join(data_root, dataset_name)
    if not os.path.exists(os.path.join(dataset_dir, "raw.arrow")):
        print(f"Error: {dataset_dir}/raw.arrow not found.")
        return None
    stats = ngram_stats(_rows_from_arrow(dataset_dir))
    if not silent:
        print(f"\nAnalysis Result for: {dataset_name}")
        print(f"{'N-gram':<8} | {'Vocab':<10} | {'Count':<10} | {'Gini':<8} | "
              f"{'Shannon':<8} | {'Renyi(2.5)':<10} | {'Eff':<6}")
        for n, s in stats.items():
            print(f"{n}-gram   | {s['vocab']:<10} | {s['count']:<10} | "
                  f"{s['gini']:.4f}   | {s['shannon']:.4f}   | "
                  f"{s['renyi']:.4f}     | {s['eff']:.4f}")
    return stats


def analyze_all(dataset_names: Sequence[str], data_root: str | None = None,
                out_csv: str | None = None) -> list[dict]:
    """Multi-dataset summary (analyze_all_ngrams.py role)."""
    rows = []
    for name in dataset_names:
        stats = analyze_dataset(name, data_root=data_root, silent=True)
        if stats is None:
            continue
        row = {"dataset": name}
        for n, s in stats.items():
            row[f"{n}_vocab"] = s["vocab"]
            row[f"{n}_gini"] = round(s["gini"], 4)
            row[f"{n}_renyi"] = round(s["renyi"], 4)
            row[f"{n}_eff"] = round(s["eff"], 4)
        rows.append(row)
    if out_csv and rows:
        import csv

        with open(out_csv, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_analyze-ngrams")
    p.add_argument("dataset_names", nargs="+",
                   help="dataset folder name(s) under data/")
    p.add_argument("--data_root", default=None)
    p.add_argument("--out_csv", default=None,
                   help="write the multi-dataset summary table as csv")
    p.add_argument("--json", action="store_true", help="print stats as json")
    args = p.parse_args(argv)
    if len(args.dataset_names) > 1 or args.out_csv:
        rows = analyze_all(args.dataset_names, data_root=args.data_root,
                           out_csv=args.out_csv)
        if args.json:
            print(json.dumps(rows, ensure_ascii=False))
    else:
        stats = analyze_dataset(args.dataset_names[0], data_root=args.data_root,
                                silent=args.json)
        if args.json and stats:
            print(json.dumps({str(k): {kk: vv for kk, vv in v.items() if kk != "top"}
                              for k, v in stats.items()}, ensure_ascii=False))


if __name__ == "__main__":
    main()
