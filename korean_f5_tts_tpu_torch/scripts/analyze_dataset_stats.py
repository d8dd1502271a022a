"""Dataset statistics: durations, token counts, n-gram distribution (a copy
of korean_f5_tts_tpu/scripts/analyze_dataset_stats.py over the port's
data/dataset._read_arrow_rows).

Role parity with reference `train/datasets/analyze_dataset_stats.py`,
`summarize_dataset_stats.py`, and `scripts/analyze_ngram_dist.py` /
`analyze_all_ngrams.py` (token n-gram Gini/entropy across tokenizer modes).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from collections import Counter


def duration_stats(durations: list[float]) -> dict:
    import numpy as np

    d = np.asarray(durations)
    return {
        "n": int(d.size),
        "total_hours": float(d.sum() / 3600),
        "mean_s": float(d.mean()),
        "p50_s": float(np.percentile(d, 50)),
        "p95_s": float(np.percentile(d, 95)),
        "min_s": float(d.min()),
        "max_s": float(d.max()),
    }


def ngram_distribution(token_rows: list[list[str]], n: int = 2) -> Counter:
    counts: Counter = Counter()
    for toks in token_rows:
        for i in range(len(toks) - n + 1):
            counts[tuple(toks[i: i + n])] += 1
    return counts


def gini(counts: Counter) -> float:
    """Gini coefficient of the n-gram frequency distribution (0 = uniform)."""
    values = sorted(counts.values())
    n = len(values)
    total = sum(values)
    if n <= 1 or total == 0:
        return 0.0
    weighted = sum(i * v for i, v in enumerate(values, 1))
    return (2.0 * weighted) / (n * total) - (n + 1.0) / n


def entropy(counts: Counter) -> float:
    total = sum(counts.values())
    if total == 0:
        return 0.0
    return -sum((c / total) * math.log2(c / total) for c in counts.values())


def analyze_dataset(data_dir: str, dataset: str, tokenizer: str,
                    ngram_n: int = 2) -> dict:
    base = os.path.join(data_dir, f"{dataset}_{tokenizer}")
    with open(os.path.join(base, "duration.json"), "r", encoding="utf-8") as f:
        durations = json.load(f)["duration"]
    from korean_f5_tts_tpu_torch.data.dataset import _read_arrow_rows

    rows = _read_arrow_rows(os.path.join(base, "raw.arrow"))
    token_rows = [list(r["text"]) for r in rows]
    ngrams = ngram_distribution(token_rows, ngram_n)
    return {
        "dataset": f"{dataset}_{tokenizer}",
        **duration_stats(durations),
        "vocab_in_use": len({t for r in token_rows for t in r}),
        f"{ngram_n}gram_types": len(ngrams),
        f"{ngram_n}gram_entropy_bits": round(entropy(ngrams), 3),
        f"{ngram_n}gram_gini": round(gini(ngrams), 4),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", default="data")
    p.add_argument("--dataset", required=True)
    p.add_argument("--tokenizers", nargs="+", required=True)
    p.add_argument("--ngram", type=int, default=2)
    args = p.parse_args(argv)
    for tok in args.tokenizers:
        print(json.dumps(analyze_dataset(args.data_dir, args.dataset, tok,
                                         args.ngram), ensure_ascii=False))


if __name__ == "__main__":
    main()
