"""Fine-tuning entry point (counterpart of korean_f5_tts_tpu/train/finetune_cli.py).

    python -m korean_f5_tts_tpu_torch.train.finetune_cli --dataset_name KSS \\
        --tokenizer kor_allophone --pretrain model_1250000.safetensors [--device cpu]

Per-model presets (config.py:PRESETS), the pretrained checkpoint (a .npz,
or a reference .pt / .safetensors) copied into the run directory as
pretrained_<name> so that rotation never deletes it, then loaded; without
one the run starts from a seeded init. The Trainer runs in fp32 (no compute
dtype, as the JAX CLI's), on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

from korean_f5_tts_tpu_torch.config import PRESETS, preset_model_config
from korean_f5_tts_tpu_torch.data.dataset import load_dataset
from korean_f5_tts_tpu_torch.infer.model import _INIT_FNS, load_checkpoint_into_pytree
from korean_f5_tts_tpu_torch.text.vocab import get_tokenizer
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from korean_f5_tts_tpu_torch.train.trainer import Trainer
from korean_f5_tts_tpu_torch.utils.misc import require_device


def build_parser():
    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.train.finetune_cli")
    p.add_argument("--exp_name", default="F5TTS_v1_Base", choices=sorted(PRESETS))
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--pretrain", default=None, help="pretrained checkpoint to start from")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--batch_size_per_gpu", type=int, default=9_600)
    p.add_argument("--batch_size_type", default="frame", choices=["frame", "sample"])
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_warmup_updates", type=int, default=20_000)
    p.add_argument("--save_per_updates", type=int, default=50_000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--last_per_updates", type=int, default=5_000)
    p.add_argument("--finetune", action="store_true", default=True)
    p.add_argument("--tokenizer", default="pinyin")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--logger", default="tensorboard", choices=["tensorboard", "none"])
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = require_device(args.device)
    model_cfg = preset_model_config(args.exp_name)
    if args.tokenizer == "custom":
        vocab_char_map, vocab_size = get_tokenizer(args.tokenizer_path, "custom")
    else:
        vocab_char_map, vocab_size = get_tokenizer(args.dataset_name, args.tokenizer)
    arch = dataclasses.replace(model_cfg.arch, text_num_embeds=vocab_size + 1)

    ckpt_dir = os.path.join("ckpts", f"{args.exp_name}_{args.tokenizer}_{args.dataset_name}")
    os.makedirs(ckpt_dir, exist_ok=True)
    if args.pretrain:
        dst = os.path.join(ckpt_dir, "pretrained_" + os.path.basename(args.pretrain))
        if not os.path.exists(dst):
            shutil.copy2(args.pretrain, dst)
        tree = load_checkpoint_into_pytree(dst, arch, model_cfg.backbone)
        params = params_from_jax(flatten_tree(tree), device=device)
    else:
        params = _INIT_FNS[model_cfg.backbone](arch, seed=666, device=device)

    dataset = load_dataset(args.dataset_name, args.tokenizer)
    trainer = Trainer(
        params, arch,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        num_warmup_updates=args.num_warmup_updates,
        save_per_updates=args.save_per_updates,
        keep_last_n_checkpoints=args.keep_last_n_checkpoints,
        checkpoint_path=ckpt_dir,
        batch_size_per_gpu=args.batch_size_per_gpu,
        batch_size_type=args.batch_size_type,
        max_samples=args.max_samples,
        grad_accumulation_steps=args.grad_accumulation_steps,
        max_grad_norm=args.max_grad_norm,
        last_per_updates=args.last_per_updates,
        logger=None if args.logger == "none" else args.logger,
        vocab_char_map=vocab_char_map,
    )
    result = trainer.train(dataset, resumable_with_seed=666, max_updates=args.max_updates)
    print(f"finetune done at update {result['updates']}")


if __name__ == "__main__":
    main()
