"""Training entry point from a YAML config (counterpart of
korean_f5_tts_tpu/train/train.py).

    python -m korean_f5_tts_tpu_torch.train.train -c configs/F5TTS_Base_ft_KSS.yaml \\
        [--max_updates N] [--device cpu] [datasets.batch_size_per_gpu=4800 ...]

Reads the reference's YAML schema (model/arch, model/mel_spec, datasets,
optim, ckpts) without Hydra; dotted key=value overrides follow the options.
ckpts.pretrained_path (a .npz, or a reference .pt / .safetensors) is loaded
through infer/model.py:load_checkpoint_into_pytree when the file exists, else
a warning is printed and training starts from the seeded init;
datasets.load_path names the dataset directory itself. The Trainer runs in
fp32 (no compute dtype, as the JAX CLI's), on the card unless --device cpu.

Several processes (train.py:44-52, 79, 96): started with the JAX package's
variables (F5_TTS_DIST_COORDINATOR, F5_TTS_DIST_NUM_PROCESSES,
F5_TTS_DIST_PROCESS_ID; parallel/distributed.py), one process a device,
they train on one (n_processes / n_model_shards, n_model_shards) data x
model mesh, each on its share of the weights and its rows of every batch
(NCCL on the card, gloo with --device cpu).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from korean_f5_tts_tpu_torch.config import model_config_from_dict
from korean_f5_tts_tpu_torch.data.dataset import load_dataset
from korean_f5_tts_tpu_torch.infer.model import _INIT_FNS, load_checkpoint_into_pytree
from korean_f5_tts_tpu_torch.parallel.distributed import maybe_initialize_distributed
from korean_f5_tts_tpu_torch.parallel.mesh import make_mesh, shard_params
from korean_f5_tts_tpu_torch.text.vocab import get_tokenizer
from korean_f5_tts_tpu_torch.train.checkpoint import flatten_tree, params_from_jax
from korean_f5_tts_tpu_torch.train.trainer import Trainer
from korean_f5_tts_tpu_torch.utils.misc import require_device


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Dotted key=value overrides, values parsed as YAML (train.py:25-37; a
    value that is no YAML raises here, where the JAX CLI keeps its text)."""
    import yaml

    for ov in overrides:
        key, _, val = ov.lstrip("+").partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(val)
    return cfg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.train.train")
    parser.add_argument("--config", "-c", required=True, help="training yaml")
    parser.add_argument("--max_updates", type=int, default=None)
    parser.add_argument("--n_model_shards", type=int, default=1,
                        help="tensor-parallel degree over the processes' mesh")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    device = require_device(args.device)
    # several processes: the Accelerate-DDP equivalent (reference trainer.py:59-70)
    mesh = None
    if maybe_initialize_distributed(device) or args.n_model_shards > 1:
        mesh = make_mesh(n_model=args.n_model_shards, device=device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    import yaml

    with open(args.config, "r", encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    cfg = apply_overrides(cfg, args.overrides)

    model_cfg = model_config_from_dict(cfg)
    ds_cfg, optim, ckpts = (cfg.get(k, {}) for k in ("datasets", "optim", "ckpts"))
    tokenizer = cfg.get("model", {}).get("tokenizer", "pinyin")
    dataset_name = ds_cfg.get("name", "Emilia_ZH_EN")
    if tokenizer == "custom":
        vocab_char_map, vocab_size = get_tokenizer(cfg["model"]["tokenizer_path"], "custom")
    else:
        vocab_char_map, vocab_size = get_tokenizer(dataset_name, tokenizer)
    arch = dataclasses.replace(model_cfg.arch, text_num_embeds=vocab_size + 1)

    params = _INIT_FNS[model_cfg.backbone](arch, seed=666, device=device)
    pretrained = ckpts.get("pretrained_path")
    if pretrained:
        if os.path.exists(pretrained):
            tree = load_checkpoint_into_pytree(pretrained, arch, model_cfg.backbone)
            params = params_from_jax(flatten_tree(tree), device=device)
            print(f"loaded pretrained params from {pretrained}")
        else:
            print(f"WARNING: ckpts.pretrained_path {pretrained} not found; "
                  "training from scratch")

    params = shard_params(params, mesh)

    load_path = ds_cfg.get("load_path")
    mel = model_cfg.mel
    dataset = load_dataset(
        load_path or dataset_name, tokenizer,
        dataset_type="CustomDatasetPath" if load_path else "CustomDataset",
        mel_spec_kwargs=dict(n_fft=mel.n_fft, hop_length=mel.hop_length,
                             win_length=mel.win_length, n_mel_channels=mel.n_mel_channels,
                             target_sample_rate=mel.target_sample_rate,
                             mel_spec_type=mel.mel_spec_type))
    save_dir = ckpts.get("save_dir",
                         f"ckpts/{model_cfg.name}_{mel.mel_spec_type}_{tokenizer}_{dataset_name}")
    trainer = Trainer(
        params, arch,
        epochs=optim.get("epochs", 1),
        # float(): YAML reads an exponent without a dot ("1e-5") as a string
        learning_rate=float(optim.get("learning_rate", 7.5e-5)),
        num_warmup_updates=optim.get("num_warmup_updates", 20_000),
        save_per_updates=ckpts.get("save_per_updates", 50_000),
        keep_last_n_checkpoints=ckpts.get("keep_last_n_checkpoints", -1),
        checkpoint_path=save_dir,
        batch_size_per_gpu=ds_cfg.get("batch_size_per_gpu", 38_400),
        batch_size_type=ds_cfg.get("batch_size_type", "frame"),
        max_samples=ds_cfg.get("max_samples", 64),
        grad_accumulation_steps=optim.get("grad_accumulation_steps", 1),
        max_grad_norm=float(optim.get("max_grad_norm", 1.0)),
        last_per_updates=ckpts.get("last_per_updates", 5_000),
        logger=ckpts.get("logger", "tensorboard"),
        mesh=mesh,
        vocab_char_map=vocab_char_map,
    )
    os.makedirs(save_dir, exist_ok=True)
    result = trainer.train(dataset, num_workers=ds_cfg.get("num_workers", 0),
                           resumable_with_seed=666, max_updates=args.max_updates)
    print(f"done at update {result['updates']}")


if __name__ == "__main__":
    main()
