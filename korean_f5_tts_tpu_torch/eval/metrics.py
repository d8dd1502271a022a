"""Text metrics: WER / CER via edit distance (pure python).

The reference computes these through jiwer (`eval/utils_eval.py:306-374`);
jiwer is not a dependency, so the Levenshtein core is implemented directly.
Semantics match jiwer defaults: WER over whitespace tokens, CER over
characters.

A copy of korean_f5_tts_tpu/eval/metrics.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations


def _edit_distance(ref: list, hyp: list) -> int:
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def word_error_rate(reference: str, hypothesis: str) -> float:
    ref = reference.split()
    hyp = hypothesis.split()
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


def char_error_rate(reference: str, hypothesis: str) -> float:
    ref = list(reference.replace(" ", ""))
    hyp = list(hypothesis.replace(" ", ""))
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(ref, hyp) / len(ref)


_PUNCT = set(".,!?;:\"'“”‘’、。，！？；：·…()[]{}<>-—~")


def strip_punctuation(text: str) -> str:
    """Punctuation strip used before scoring (evaluate_models.py:154-158)."""
    return "".join(c for c in text if c not in _PUNCT)
