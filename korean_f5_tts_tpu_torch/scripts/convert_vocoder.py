"""Convert a torch Vocos checkpoint to the flat .npz that
api.load_vocoder(is_local=True, local_path=...) reads (counterpart of
korean_f5_tts_tpu/scripts/convert_vocoder.py, the same file for the same
input).

    python -m korean_f5_tts_tpu_torch.scripts.convert_vocoder --input vocos.bin \\
        --output vocos.npz

Host work only: the state dict is converted in numpy to the JAX layouts
(utils/torch_ckpt.py:convert_vocos_state_dict), which either package loads.
"""

from __future__ import annotations

import argparse

import numpy as np

from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree
from korean_f5_tts_tpu_torch.utils.torch_ckpt import convert_vocos_state_dict, load_torch_checkpoint


def convert(in_path: str, out_path: str, num_layers: int = 8) -> None:
    sd = load_torch_checkpoint(in_path)
    params = convert_vocos_state_dict(sd, num_layers=num_layers)
    np.savez(out_path, **flatten_tree(params))
    print(f"{out_path}: converted vocos checkpoint ({num_layers} layers)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.scripts.convert_vocoder")
    p.add_argument("--input", required=True, help="torch .bin/.pt/.safetensors")
    p.add_argument("--output", required=True, help=".npz path")
    p.add_argument("--num_layers", type=int, default=8)
    args = p.parse_args(argv)
    convert(args.input, args.output, args.num_layers)


if __name__ == "__main__":
    main()
