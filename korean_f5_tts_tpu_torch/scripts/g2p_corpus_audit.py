"""Corpus-level G2P divergence audit (a copy of
korean_f5_tts_tpu/scripts/g2p_corpus_audit.py over the port's text/g2p_ko.py).

Runs g2p over the stratified sample in tests/goldens/g2p_corpus_sample.tsv
(hand-audited standard pronunciations, '|'-separated admitted variants) and
prints the divergence rate of each rule class, then every mismatch:

    python -m korean_f5_tts_tpu_torch.scripts.g2p_corpus_audit [--sample PATH]

Reference counterpart: g2pk2 inside get_g2p()
(src/f5_tts/model/utils.py:160-166 of the reference).
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

from korean_f5_tts_tpu_torch.text.g2p_ko import g2p

SAMPLE = Path(__file__).resolve().parents[2] / "tests" / "goldens" / "g2p_corpus_sample.tsv"


def main(sample: str | Path = SAMPLE) -> tuple[int, int]:
    """Print the per-class table and the mismatches; return (mismatches, rows)."""
    per_class = defaultdict(lambda: [0, 0])  # class -> [n, mismatches]
    mismatches = []
    for line in Path(sample).read_text(encoding="utf-8").splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        cls, text, expected = line.split("\t")
        got = g2p(text)
        ok = got in expected.split("|")
        per_class[cls][0] += 1
        per_class[cls][1] += 0 if ok else 1
        if not ok:
            mismatches.append((cls, text, expected, got))

    total_n = sum(v[0] for v in per_class.values())
    total_m = sum(v[1] for v in per_class.values())
    print(f"{'class':<12} {'n':>4} {'diverge':>8} {'rate':>7}")
    for cls in sorted(per_class):
        n, m = per_class[cls]
        print(f"{cls:<12} {n:>4} {m:>8} {m / n:>6.1%}")
    print(f"{'TOTAL':<12} {total_n:>4} {total_m:>8} {total_m / total_n:>6.1%}")
    print()
    for cls, text, expected, got in mismatches:
        print(f"[{cls}] {text}\n   want: {expected}\n   got:  {got}")
    return total_m, total_n


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sample", default=str(SAMPLE), help="tab-separated class, text, expected")
    main(p.parse_args().sample)
