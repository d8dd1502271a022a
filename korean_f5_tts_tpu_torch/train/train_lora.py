"""LoRA fine-tuning entry point (counterpart of
korean_f5_tts_tpu/train/train_lora.py).

    python -m korean_f5_tts_tpu_torch.train.train_lora --config \\
        configs/F5TTS_Base_ft_Lora.yaml [--pretrain x.pt] [--max_updates N] [--device cpu]

Adapters r 16 / alpha 32 on the attention projections and r 64 / alpha 128
on the input projection (models/lora.py:DEFAULT_TARGETS); the pretrained
checkpoint (.npz, or a reference .pt / .safetensors) loads with the
shape-mismatch skip (train_lora.py:143-151: a leaf whose shape differs, such
as a text embedding grown by a vocab extension, keeps its seeded init);
--train_text_embed unfreezes the text encoder too; --load_path names the
dataset directory. The base tensors are frozen and apply_lora builds the
adapted tree inside the loss. The optimizer is a bare optax.adamw(lr)
(train/step.py:PlainAdamW): no clip, constant lr, weight decay 1e-4, and
each adapter's `scale` is trained like a and b. Training runs in fp32 (no
compute dtype, as in the JAX step), on the card unless --device cpu. Every
save writes the merged params as a .npz that either package loads.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from korean_f5_tts_tpu_torch.config import PRESETS, DiTConfig, backbone_of, preset_model_config
from korean_f5_tts_tpu_torch.data.dataset import DynamicBatchSampler, collate_batch, load_dataset
from korean_f5_tts_tpu_torch.infer.model import _INIT_FNS, load_checkpoint_into_pytree
from korean_f5_tts_tpu_torch.models.cfm import cfm_loss, cfm_loss_from_draws
from korean_f5_tts_tpu_torch.models.lora import DEFAULT_TARGETS, apply_lora, init_lora, merge_lora
from korean_f5_tts_tpu_torch.text.vocab import get_tokenizer
from korean_f5_tts_tpu_torch.train.checkpoint import (
    flatten_tree,
    params_from_jax,
    save_checkpoint,
    unflatten_tree,
)
from korean_f5_tts_tpu_torch.train.step import PlainAdamW
from korean_f5_tts_tpu_torch.utils.misc import fold_in, require_device


def trainable_leaves(base_params: dict, adapters: dict,
                     train_text_embed: bool = False) -> dict[str, torch.Tensor]:
    """The trained tensors by name: "adapters/<path>/<a|b|scale>" and, with
    train_text_embed, "text_embed/<leaf>" (the JAX step's trainable tree)."""
    named = {f"adapters/{path}/{k}": v for path, ad in adapters.items() for k, v in ad.items()}
    if train_text_embed:
        named.update({f"text_embed/{k}": v
                      for k, v in flatten_tree(base_params["text_embed"]).items()})
    return named


def lora_train_step(base_params: dict, adapters: dict, opt_state: dict, batch: dict, seed: int,
                    arch: DiTConfig, optimizer: PlainAdamW, train_text_embed: bool = False,
                    draws: dict | None = None):
    """One update of the adapters (and the text embedding) on a batch
    {mel [b, n, d], text [b, nt], lens [b]} (train_lora.py:34-61); the loss's
    draws come from `seed`, or are `draws` (models/cfm.py:draw_cfm's dict,
    dropout off). The trained tensors are updated in place; returns
    (adapters, base_params, opt_state, loss)."""
    named = trainable_leaves(base_params, adapters, train_text_embed)
    live = {k: v.detach().requires_grad_(True) for k, v in named.items()}
    merged = apply_lora(base_params, {
        path: {k: live[f"adapters/{path}/{k}"] for k in ad} for path, ad in adapters.items()})
    if train_text_embed:
        merged["text_embed"] = unflatten_tree({k[len("text_embed/"):]: v for k, v in live.items()
                                               if k.startswith("text_embed/")})
    args = (merged, arch, batch["mel"], batch["text"], batch["lens"])
    if draws is None:
        loss = cfm_loss(*args, seed)[0]
    else:
        loss = cfm_loss_from_draws(*args, draws)[0]
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live.values(), grads)]
    with torch.no_grad():
        optimizer.update_(list(named.values()), grads, opt_state, list(named))
    return adapters, base_params, opt_state, loss.detach()


def apply_recipe_config(args, config_path: str) -> None:
    """Fill unset arguments from a recipe YAML (configs/F5TTS_Base_ft_Lora_*),
    train_lora.py:64-86; explicit flags beat the file. Mutates `args`."""
    import yaml

    with open(config_path, encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    ds, opt, m, ck = (cfg.get(k, {}) for k in ("datasets", "optim", "model", "ckpts"))
    args.dataset_name = args.dataset_name or ds.get("name")
    args.load_path = getattr(args, "load_path", None) or ds.get("load_path")
    args.pretrain = args.pretrain or ck.get("pretrained_path")
    if args.learning_rate is None:
        args.learning_rate = float(opt.get("learning_rate", 1e-4))
    if args.batch_size_per_gpu is None:
        args.batch_size_per_gpu = int(ds.get("batch_size_per_gpu", 9_600))
    if args.epochs is None:
        args.epochs = int(opt.get("epochs", 100))
    args.tokenizer = args.tokenizer or m.get("tokenizer")
    args.tokenizer_path = args.tokenizer_path or m.get("tokenizer_path")
    if m.get("name") in PRESETS:
        args.exp_name = m["name"]


def load_base_params(pretrain: str, arch: DiTConfig, device) -> dict:
    """The pretrained params over a seeded init (seed 666): every leaf whose
    shape the checkpoint matches is the checkpoint's, the others keep the
    init (train_lora.py:143-151)."""
    params = flatten_tree(_INIT_FNS[backbone_of(arch)](arch, seed=666, device=device))
    loaded = params_from_jax(flatten_tree(load_checkpoint_into_pytree(pretrain, arch)),
                             device=device)
    for path, leaf in flatten_tree(loaded).items():
        if path in params and leaf.shape == params[path].shape:
            params[path] = leaf
    return unflatten_tree(params)


def train_loop(base_params: dict, adapters: dict, optimizer: PlainAdamW, opt_state: dict,
               dataset, arch: DiTConfig, vocab_char_map: dict[str, int] | None, ckpt_dir: str,
               batch_size_per_gpu: int = 9_600, epochs: int = 1, max_updates: int | None = None,
               save_every: int = 5_000, train_text_embed: bool = False, seed: int = 666) -> dict:
    """train_lora's update loop (train_lora.py:170-196) over any dataset with
    get_frame_len and items {mel_spec, text}: frame-budgeted batches (at most
    64 rows, shuffled from `seed`), one lora_train_step each with the seed
    fold_in(seed, update), the merged params saved to ckpt_dir/model_last.npz
    every save_every updates and at the end. Returns {"updates", "losses",
    "path"}."""
    device = flatten_tree(base_params)["input_proj/w"].device
    sampler = DynamicBatchSampler(dataset, batch_size_per_gpu, max_samples=64, random_seed=seed)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "model_last.npz")
    update, losses = 0, []
    for epoch in range(epochs):
        sampler.set_epoch(epoch)
        for batch_idx in sampler:
            b = collate_batch([dataset[i] for i in batch_idx], vocab_char_map)
            batch = {k: torch.from_numpy(b[src]).to(device)
                     for k, src in (("mel", "mel"), ("text", "text"), ("lens", "mel_lengths"))}
            adapters, base_params, opt_state, loss = lora_train_step(
                base_params, adapters, opt_state, batch, fold_in(seed, update), arch, optimizer,
                train_text_embed=train_text_embed)
            update += 1
            losses.append(float(loss))
            if update % 10 == 0:
                print(f"update {update} loss {losses[-1]:.4f}")
            done = max_updates is not None and update >= max_updates
            if update % save_every == 0 or done:
                save_checkpoint(path, merge_lora(base_params, adapters), update=update)
            if done:
                return {"updates": update, "losses": losses, "path": path}
    save_checkpoint(path, merge_lora(base_params, adapters), update=update)
    return {"updates": update, "losses": losses, "path": path}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m korean_f5_tts_tpu_torch.train.train_lora")
    p.add_argument("--config", default=None,
                   help="recipe YAML (configs/F5TTS_Base_ft_Lora_*.yaml); explicit flags "
                        "override its values")
    p.add_argument("--exp_name", default="F5TTS_Base", choices=sorted(PRESETS))
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--pretrain", default=None)
    p.add_argument("--load_path", default=None, help="dataset directory override")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--batch_size_per_gpu", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--train_text_embed", action="store_true",
                   help="also unfreeze the text encoder (CoreaSpeech hybrid)")
    p.add_argument("--max_updates", type=int, default=None)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.config:
        apply_recipe_config(args, args.config)
    if not args.dataset_name or not args.pretrain:
        p.error("--dataset_name and --pretrain are required (directly or via --config)")
    args.learning_rate = 1e-4 if args.learning_rate is None else args.learning_rate
    args.batch_size_per_gpu = args.batch_size_per_gpu or 9_600
    args.epochs = args.epochs or 100
    args.tokenizer = args.tokenizer or "pinyin"
    device = require_device(args.device)

    model_cfg = preset_model_config(args.exp_name)
    if args.tokenizer == "custom":
        vocab_char_map, vocab_size = get_tokenizer(args.tokenizer_path, "custom")
    else:
        vocab_char_map, vocab_size = get_tokenizer(args.dataset_name, args.tokenizer)
    arch = dataclasses.replace(model_cfg.arch, text_num_embeds=vocab_size + 1)

    base_params = load_base_params(args.pretrain, arch, device)
    adapters = init_lora(base_params, DEFAULT_TARGETS, seed=0)
    optimizer = PlainAdamW(learning_rate=args.learning_rate)
    opt_state = optimizer.init(trainable_leaves(base_params, adapters, args.train_text_embed))
    dataset = load_dataset(
        args.load_path or args.dataset_name, args.tokenizer,
        dataset_type="CustomDatasetPath" if args.load_path else "CustomDataset")
    result = train_loop(
        base_params, adapters, optimizer, opt_state, dataset, arch, vocab_char_map,
        os.path.join("ckpts", f"lora_{args.exp_name}_{args.dataset_name}"),
        batch_size_per_gpu=args.batch_size_per_gpu, epochs=args.epochs,
        max_updates=args.max_updates, save_every=args.save_every,
        train_text_embed=args.train_text_embed)
    print(f"lora done at update {result['updates']}")


if __name__ == "__main__":
    main()
