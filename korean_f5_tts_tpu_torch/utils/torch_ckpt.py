"""Reference torch checkpoints -> the JAX package's parameter trees (DiT,
UNetT, MMDiT, Vocos), the LoRA merge of a state dict, and the inverse of the
DiT and Vocos converters.

A copy of korean_f5_tts_tpu/utils/torch_ckpt.py (numpy only; torch and
safetensors are imported inside load_torch_checkpoint), so the two packages
convert a checkpoint to the same tree, leaf for leaf. The trees are in the
JAX layouts; train/checkpoint.py:flatten_tree and params_from_jax carry them
to the port's tensors.

Key transforms:
  - Linear  torch [out, in]        -> {"w": [in, out]} (transpose) + "b"
  - Conv1d  torch [out, in/g, k]   -> {"w": [k, in/g, out]} (transpose 2,1,0)
  - to_q / to_k (+ q/k-norm) columns permuted per head from the interleaved
    rope layout of the reference to the half-split layout both packages run
    (attention logits are invariant to a shared q/k permutation), so a
    converted tree is never permuted again.

dit_state_dict, unett_state_dict and vocos_state_dict, the port's own,
invert the converters:
they write a tree in the reference's names and layouts, which is how a
checkpoint is made from seeded weights where no published one may be
downloaded.
"""

from __future__ import annotations

import numpy as np


def _lin(sd: dict, name: str) -> dict:
    p = {"w": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).T)}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _conv(sd: dict, name: str) -> dict:
    p = {"w": np.ascontiguousarray(np.asarray(sd[f"{name}.weight"]).transpose(2, 1, 0))}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _ln(sd: dict, name: str) -> dict:
    p = {}
    if f"{name}.weight" in sd:
        p["g"] = np.asarray(sd[f"{name}.weight"])
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"])
    return p


def _rope_perm(dim_head: int) -> np.ndarray:
    # interleaved pairs (0,1),(2,3).. -> half-split [evens | odds]
    return np.concatenate([np.arange(0, dim_head, 2), np.arange(1, dim_head, 2)])


def _permute_qk(p: dict, heads: int, dim_head: int) -> dict:
    perm = _rope_perm(dim_head)
    full = np.concatenate([h * dim_head + perm for h in range(heads)])
    out = dict(p)
    out["w"] = np.ascontiguousarray(p["w"][:, full])
    if "b" in p:
        out["b"] = np.ascontiguousarray(p["b"][full])
    return out


def strip_ema_prefix(sd: dict) -> dict:
    """EMA checkpoints store ema_model.* keys (utils_infer.py:255-263)."""
    if any(k.startswith("ema_model.") for k in sd):
        sd = {
            k.replace("ema_model.", ""): v
            for k, v in sd.items()
            if k not in ("initted", "step") and k.startswith("ema_model.")
        }
    # drop CFM-level wrappers: transformer.* prefix and mel_spec buffers
    out = {}
    for k, v in sd.items():
        if k.startswith("transformer."):
            out[k[len("transformer."):]] = v
        elif not k.startswith("mel_spec."):
            out[k] = v
    return out


def merge_lora(sd: dict, alpha_over_r: float | None = None) -> dict:
    """Merge PEFT LoRA A/B pairs into base weights (utils_infer.py:198-239)."""

    def norm(k: str) -> str:
        return k.replace("base_model.model.", "").replace("base_layer.", "")

    base = {norm(k): v for k, v in sd.items() if "lora_" not in k}
    lora_a = {k: v for k, v in sd.items() if "lora_A" in k}
    for ka, a in lora_a.items():
        kb = ka.replace("lora_A", "lora_B")
        if kb not in sd:
            continue
        b = sd[kb]
        target = norm(ka.replace(".lora_A.weight", ".weight"))
        scale = alpha_over_r if alpha_over_r is not None else 1.0
        if target in base:
            base[target] = np.asarray(base[target]) + scale * (np.asarray(b) @ np.asarray(a))
    return base


def convert_convnext_v2(sd: dict, prefix: str) -> dict:
    return {
        "dwconv": _conv(sd, f"{prefix}.dwconv"),
        "norm": _ln(sd, f"{prefix}.norm"),
        "pw1": _lin(sd, f"{prefix}.pwconv1"),
        "grn": {"gamma": np.asarray(sd[f"{prefix}.grn.gamma"]),
                "beta": np.asarray(sd[f"{prefix}.grn.beta"])},
        "pw2": _lin(sd, f"{prefix}.pwconv2"),
    }


def _convert_attention(sd: dict, prefix: str, heads: int, dim_head: int) -> dict:
    p = {
        "to_q": _permute_qk(_lin(sd, f"{prefix}.to_q"), heads, dim_head),
        "to_k": _permute_qk(_lin(sd, f"{prefix}.to_k"), heads, dim_head),
        "to_v": _lin(sd, f"{prefix}.to_v"),
        "to_out": _lin(sd, f"{prefix}.to_out.0"),
    }
    if f"{prefix}.q_norm.weight" in sd:
        perm = _rope_perm(dim_head)
        p["q_norm"] = {"g": np.asarray(sd[f"{prefix}.q_norm.weight"])[perm]}
        p["k_norm"] = {"g": np.asarray(sd[f"{prefix}.k_norm.weight"])[perm]}
    return p


def convert_dit_state_dict(sd: dict, heads: int, dim_head: int, depth: int,
                           conv_layers: int) -> dict:
    """Reference DiT state_dict -> this framework's param pytree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    text_embed = {"embed": {"w": sd["text_embed.text_embed.weight"]}}
    if conv_layers > 0:
        text_embed["blocks"] = [
            convert_convnext_v2(sd, f"text_embed.text_blocks.{i}")
            for i in range(conv_layers)
        ]
    p = {
        "time_embed": {
            "mlp1": _lin(sd, "time_embed.time_mlp.0"),
            "mlp2": _lin(sd, "time_embed.time_mlp.2"),
        },
        "text_embed": text_embed,
        "input_proj": _lin(sd, "input_embed.proj"),
        "conv_pos_embed": {
            "conv1": _conv(sd, "input_embed.conv_pos_embed.conv1d.0"),
            "conv2": _conv(sd, "input_embed.conv_pos_embed.conv1d.2"),
        },
        "blocks": [
            {
                "attn_norm": {"linear": _lin(sd, f"transformer_blocks.{i}.attn_norm.linear")},
                "attn": _convert_attention(sd, f"transformer_blocks.{i}.attn", heads, dim_head),
                "ff": {
                    "in": _lin(sd, f"transformer_blocks.{i}.ff.ff.0.0"),
                    "out": _lin(sd, f"transformer_blocks.{i}.ff.ff.2"),
                },
            }
            for i in range(depth)
        ],
        "norm_out": {"linear": _lin(sd, "norm_out.linear")},
        "proj_out": _lin(sd, "proj_out"),
    }
    if "long_skip_connection.weight" in sd:
        p["long_skip"] = _lin(sd, "long_skip_connection")
    return p


def convert_unett_state_dict(sd: dict, heads: int, dim_head: int, depth: int,
                             conv_layers: int, skip_connect_type: str = "concat") -> dict:
    sd = {k: np.asarray(v) for k, v in sd.items()}
    text_embed = {"embed": {"w": sd["text_embed.text_embed.weight"]}}
    if conv_layers > 0:
        text_embed["blocks"] = [
            convert_convnext_v2(sd, f"text_embed.text_blocks.{i}")
            for i in range(conv_layers)
        ]
    layers = []
    for i in range(depth):
        # reference layer ModuleList order: [skip_proj, attn_norm, attn, ff_norm, ff]
        layer = {
            "attn_norm": {"g": np.asarray(sd[f"layers.{i}.1.g"])},
            "attn": _convert_attention(sd, f"layers.{i}.2", heads, dim_head),
            "ff_norm": {"g": np.asarray(sd[f"layers.{i}.3.g"])},
            "ff": {
                "in": _lin(sd, f"layers.{i}.4.ff.0.0"),
                "out": _lin(sd, f"layers.{i}.4.ff.2"),
            },
        }
        if skip_connect_type == "concat" and i >= depth // 2:
            layer["skip_proj"] = _lin(sd, f"layers.{i}.0")
        layers.append(layer)
    return {
        "time_embed": {
            "mlp1": _lin(sd, "time_embed.time_mlp.0"),
            "mlp2": _lin(sd, "time_embed.time_mlp.2"),
        },
        "text_embed": text_embed,
        "input_proj": _lin(sd, "input_embed.proj"),
        "conv_pos_embed": {
            "conv1": _conv(sd, "input_embed.conv_pos_embed.conv1d.0"),
            "conv2": _conv(sd, "input_embed.conv_pos_embed.conv1d.2"),
        },
        "layers": layers,
        "norm_out": {"g": np.asarray(sd["norm_out.g"])},
        "proj_out": _lin(sd, "proj_out"),
    }


def convert_mmdit_state_dict(sd: dict, heads: int, dim_head: int, depth: int) -> dict:
    """Reference MMDiT state_dict -> this framework's param pytree.

    Name map per the reference's src/f5_tts/model/backbones/mmdit.py:85-143 and
    MMDiTBlock at modules.py:703-771. Both streams' q/k projections (and
    qk-norm gains) take the interleaved->half-split rope column permutation,
    since the joint attention ropes x AND c queries/keys."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    blocks = []
    for i in range(depth):
        pre = f"transformer_blocks.{i}"
        context_pre_only = i == depth - 1
        attn = {
            "to_q": _permute_qk(_lin(sd, f"{pre}.attn.to_q"), heads, dim_head),
            "to_k": _permute_qk(_lin(sd, f"{pre}.attn.to_k"), heads, dim_head),
            "to_v": _lin(sd, f"{pre}.attn.to_v"),
            "to_out": _lin(sd, f"{pre}.attn.to_out.0"),
            "to_q_c": _permute_qk(_lin(sd, f"{pre}.attn.to_q_c"), heads, dim_head),
            "to_k_c": _permute_qk(_lin(sd, f"{pre}.attn.to_k_c"), heads, dim_head),
            "to_v_c": _lin(sd, f"{pre}.attn.to_v_c"),
        }
        if f"{pre}.attn.q_norm.weight" in sd:
            perm = _rope_perm(dim_head)
            attn["q_norm"] = {"g": sd[f"{pre}.attn.q_norm.weight"][perm]}
            attn["k_norm"] = {"g": sd[f"{pre}.attn.k_norm.weight"][perm]}
            attn["c_q_norm"] = {"g": sd[f"{pre}.attn.c_q_norm.weight"][perm]}
            attn["c_k_norm"] = {"g": sd[f"{pre}.attn.c_k_norm.weight"][perm]}
        if not context_pre_only:
            attn["to_out_c"] = _lin(sd, f"{pre}.attn.to_out_c")
        blk = {
            "attn_norm_x": {"linear": _lin(sd, f"{pre}.attn_norm_x.linear")},
            "attn_norm_c": {"linear": _lin(sd, f"{pre}.attn_norm_c.linear")},
            "attn": attn,
            "ff_x": {"in": _lin(sd, f"{pre}.ff_x.ff.0.0"),
                     "out": _lin(sd, f"{pre}.ff_x.ff.2")},
        }
        if not context_pre_only:
            blk["ff_c"] = {"in": _lin(sd, f"{pre}.ff_c.ff.0.0"),
                           "out": _lin(sd, f"{pre}.ff_c.ff.2")}
        blocks.append(blk)
    return {
        "time_embed": {
            "mlp1": _lin(sd, "time_embed.time_mlp.0"),
            "mlp2": _lin(sd, "time_embed.time_mlp.2"),
        },
        "text_embed": {"embed": {"w": sd["text_embed.text_embed.weight"]}},
        "audio_proj": _lin(sd, "audio_embed.linear"),
        "conv_pos_embed": {
            "conv1": _conv(sd, "audio_embed.conv_pos_embed.conv1d.0"),
            "conv2": _conv(sd, "audio_embed.conv_pos_embed.conv1d.2"),
        },
        "blocks": blocks,
        "norm_out": {"linear": _lin(sd, "norm_out.linear")},
        "proj_out": _lin(sd, "proj_out"),
    }


def convert_vocos_state_dict(sd: dict, num_layers: int = 8) -> dict:
    """charactr/vocos-mel-24khz state_dict -> vocos param pytree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    return {
        "embed": _conv(sd, "backbone.embed"),
        "norm": _ln(sd, "backbone.norm"),
        "blocks": [
            {
                "dwconv": _conv(sd, f"backbone.convnext.{i}.dwconv"),
                "norm": _ln(sd, f"backbone.convnext.{i}.norm"),
                "pw1": _lin(sd, f"backbone.convnext.{i}.pwconv1"),
                "pw2": _lin(sd, f"backbone.convnext.{i}.pwconv2"),
                "gamma": np.asarray(sd[f"backbone.convnext.{i}.gamma"]),
            }
            for i in range(num_layers)
        ],
        "final_norm": _ln(sd, "backbone.final_layer_norm"),
        "head": _lin(sd, "head.out"),
    }


def load_torch_checkpoint(path: str) -> dict:
    """Load .pt/.safetensors into a flat numpy state dict (host-side torch)."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "ema_model_state_dict" in ckpt:
        ckpt = ckpt["ema_model_state_dict"]
    elif isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return {k: v.float().numpy() for k, v in ckpt.items()}


# ---------------------------------------------------------------------------
# the inverse: a tree in the reference's names and layouts
# ---------------------------------------------------------------------------


def _put_lin(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _put_conv(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _put_ln(sd: dict, name: str, p: dict) -> None:
    if "g" in p:
        sd[f"{name}.weight"] = np.asarray(p["g"])
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def _unpermute_qk(p: dict, heads: int, dim_head: int) -> dict:
    inv = np.argsort(_rope_perm(dim_head))
    full = np.concatenate([h * dim_head + inv for h in range(heads)])
    out = {"w": np.asarray(p["w"])[:, full]}
    if "b" in p:
        out["b"] = np.asarray(p["b"])[full]
    return out


def _put_attention(sd: dict, prefix: str, attn: dict, heads: int, dim_head: int) -> None:
    """An attention's projections (and qk-norm gains) under `prefix`, q/k
    columns and gains back in the interleaved rope layout."""
    _put_lin(sd, f"{prefix}.to_q", _unpermute_qk(attn["to_q"], heads, dim_head))
    _put_lin(sd, f"{prefix}.to_k", _unpermute_qk(attn["to_k"], heads, dim_head))
    _put_lin(sd, f"{prefix}.to_v", attn["to_v"])
    _put_lin(sd, f"{prefix}.to_out.0", attn["to_out"])
    inv = np.argsort(_rope_perm(dim_head))
    for name in ("q_norm", "k_norm"):
        if name in attn:
            sd[f"{prefix}.{name}.weight"] = np.asarray(attn[name]["g"])[inv]


def _put_text_and_input(sd: dict, tree: dict) -> None:
    """time_embed, text_embed (with its ConvNeXt blocks), input_embed.proj and
    the conv position embedding: the names DiT and UNetT share."""
    _put_lin(sd, "time_embed.time_mlp.0", tree["time_embed"]["mlp1"])
    _put_lin(sd, "time_embed.time_mlp.2", tree["time_embed"]["mlp2"])
    sd["text_embed.text_embed.weight"] = np.asarray(tree["text_embed"]["embed"]["w"])
    for i, blk in enumerate(tree["text_embed"].get("blocks", [])):
        pre = f"text_embed.text_blocks.{i}"
        _put_conv(sd, f"{pre}.dwconv", blk["dwconv"])
        _put_ln(sd, f"{pre}.norm", blk["norm"])
        _put_lin(sd, f"{pre}.pwconv1", blk["pw1"])
        sd[f"{pre}.grn.gamma"] = np.asarray(blk["grn"]["gamma"])
        sd[f"{pre}.grn.beta"] = np.asarray(blk["grn"]["beta"])
        _put_lin(sd, f"{pre}.pwconv2", blk["pw2"])
    _put_lin(sd, "input_embed.proj", tree["input_proj"])
    _put_conv(sd, "input_embed.conv_pos_embed.conv1d.0", tree["conv_pos_embed"]["conv1"])
    _put_conv(sd, "input_embed.conv_pos_embed.conv1d.2", tree["conv_pos_embed"]["conv2"])


def dit_state_dict(tree: dict, heads: int, dim_head: int) -> dict:
    """Inverse of convert_dit_state_dict: a DiT tree in the JAX layouts ->
    the reference DiT's state dict, q/k columns (and qk-norm gains) back in
    the interleaved rope layout."""
    sd: dict = {}
    _put_text_and_input(sd, tree)
    for i, blk in enumerate(tree["blocks"]):
        pre = f"transformer_blocks.{i}"
        _put_lin(sd, f"{pre}.attn_norm.linear", blk["attn_norm"]["linear"])
        _put_attention(sd, f"{pre}.attn", blk["attn"], heads, dim_head)
        _put_lin(sd, f"{pre}.ff.ff.0.0", blk["ff"]["in"])
        _put_lin(sd, f"{pre}.ff.ff.2", blk["ff"]["out"])
    _put_lin(sd, "norm_out.linear", tree["norm_out"]["linear"])
    _put_lin(sd, "proj_out", tree["proj_out"])
    if "long_skip" in tree:
        _put_lin(sd, "long_skip_connection", tree["long_skip"])
    return sd


def unett_state_dict(tree: dict, heads: int, dim_head: int) -> dict:
    """Inverse of convert_unett_state_dict: a UNetT tree in the JAX layouts
    -> the reference UNetT's state dict (each layer's ModuleList [skip_proj,
    attn_norm, attn, ff_norm, ff]), q/k columns (and qk-norm gains) back in
    the interleaved rope layout."""
    sd: dict = {}
    _put_text_and_input(sd, tree)
    for i, layer in enumerate(tree["layers"]):
        if "skip_proj" in layer:
            _put_lin(sd, f"layers.{i}.0", layer["skip_proj"])
        sd[f"layers.{i}.1.g"] = np.asarray(layer["attn_norm"]["g"])
        _put_attention(sd, f"layers.{i}.2", layer["attn"], heads, dim_head)
        sd[f"layers.{i}.3.g"] = np.asarray(layer["ff_norm"]["g"])
        _put_lin(sd, f"layers.{i}.4.ff.0.0", layer["ff"]["in"])
        _put_lin(sd, f"layers.{i}.4.ff.2", layer["ff"]["out"])
    sd["norm_out.g"] = np.asarray(tree["norm_out"]["g"])
    _put_lin(sd, "proj_out", tree["proj_out"])
    return sd


def vocos_state_dict(tree: dict) -> dict:
    """Inverse of convert_vocos_state_dict: a Vocos tree in the JAX layouts
    -> the charactr/vocos-mel-24khz state dict."""
    sd: dict = {}
    _put_conv(sd, "backbone.embed", tree["embed"])
    _put_ln(sd, "backbone.norm", tree["norm"])
    for i, blk in enumerate(tree["blocks"]):
        pre = f"backbone.convnext.{i}"
        _put_conv(sd, f"{pre}.dwconv", blk["dwconv"])
        _put_ln(sd, f"{pre}.norm", blk["norm"])
        _put_lin(sd, f"{pre}.pwconv1", blk["pw1"])
        _put_lin(sd, f"{pre}.pwconv2", blk["pw2"])
        sd[f"{pre}.gamma"] = np.asarray(blk["gamma"])
    _put_ln(sd, "backbone.final_layer_norm", tree["final_norm"])
    _put_lin(sd, "head.out", tree["head"])
    return sd
