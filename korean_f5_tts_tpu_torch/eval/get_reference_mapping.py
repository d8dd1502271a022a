"""CLI: deterministic test->train reference-prompt mapping (counterpart of
korean_f5_tts_tpu/eval/get_reference_mapping.py).

Parity with reference root-level `get_reference_mapping.py` (duration and
punctuation constrained assignment, fixed seed). The core lives in
`evaluate_korean.build_reference_mapping`; this writes the mapping as jsonl.
Host work only: it takes no device.

    python -m korean_f5_tts_tpu_torch.eval.get_reference_mapping \\
        --test_metadata test.jsonl --train_metadata train.jsonl --output map.jsonl
"""

from __future__ import annotations

import argparse
import json

from korean_f5_tts_tpu_torch.eval.evaluate_korean import build_reference_mapping
from korean_f5_tts_tpu_torch.train.datasets.prepare import read_jsonl_corpus


def main(argv=None):
    p = argparse.ArgumentParser(prog="f5-tts_reference-mapping")
    p.add_argument("--test_metadata", required=True)
    p.add_argument("--train_metadata", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--min_dur", type=float, default=3.0)
    p.add_argument("--max_dur", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=666)
    args = p.parse_args(argv)

    test_rows = [{"utt": f"t{i:05d}", **r}
                 for i, r in enumerate(read_jsonl_corpus(args.test_metadata))]
    train_rows = read_jsonl_corpus(args.train_metadata)
    mapping = build_reference_mapping(test_rows, train_rows, args.min_dur,
                                      args.max_dur, args.seed)
    with open(args.output, "w", encoding="utf-8") as f:
        for utt, ref in mapping.items():
            f.write(json.dumps({"utt": utt, "ref": ref}, ensure_ascii=False) + "\n")
    print(f"{args.output}: {len(mapping)} mappings")
    return mapping


if __name__ == "__main__":
    main()
