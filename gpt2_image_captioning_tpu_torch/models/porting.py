"""The weight bridges: between the JAX package and the port, and between
the port and the reference's PyTorch state-dict names.

The port keeps the JAX package's parameter trees as they are (nested dicts,
a list for the transformer mapper's layers, GPT-2 blocks stacked on a
leading layer dim, ``(in, out)`` matmul weights), so crossing over is a
leaf-by-leaf copy.  The caller turns the JAX trees into numpy first
(``jax.tree.map(np.asarray, tree)``): the port never imports jax.

A bfloat16 leaf arrives as an ``ml_dtypes`` bfloat16 numpy array and becomes
a torch bfloat16 tensor bit for bit; :func:`to_numpy` returns bfloat16
tensors as float32 arrays, which hold the same values exactly.

The ``export_*`` / ``port_*`` pairs are the JAX package's
``models/porting.py`` maps for the reference's names (HF GPT-2, the
reference's ``MLPMappingNetwork`` and ``TransformerMappingNetwork``): torch
``nn.Linear`` weights are ``(out, in)`` and transposed, HF ``Conv1D``
weights are ``(in, out)`` and copied, LayerNorm ``weight``/``bias`` become
``scale``/``bias``.  The export side returns float32 CPU tensors.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.tree import tree_map
from gpt2_image_captioning_tpu_torch.models.captioner import CaptionerConfig
from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config, stack_blocks
from gpt2_image_captioning_tpu_torch.models.mapping import (
    MLPMappingConfig,
    TransformerMappingConfig,
)


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _check_gpt2(gpt: dict, cfg: GPT2Config) -> None:
    want = {
        "wte": (cfg.vocab_size, cfg.n_embd),
        "wpe": (cfg.n_positions, cfg.n_embd),
        "c_attn": (cfg.n_layer, cfg.n_embd, 3 * cfg.n_embd),
        "c_fc": (cfg.n_layer, cfg.n_embd, 4 * cfg.n_embd),
    }
    got = {
        "wte": tuple(gpt["wte"].shape),
        "wpe": tuple(gpt["wpe"].shape),
        "c_attn": tuple(gpt["blocks"]["attn"]["c_attn"]["w"].shape),
        "c_fc": tuple(gpt["blocks"]["mlp"]["c_fc"]["w"].shape),
    }
    if got != want:
        raise ValueError(f"GPT-2 params do not match {cfg}: shapes {got}, expected {want}")


def from_jax_numpy(trainable: dict, frozen: dict, cfg: CaptionerConfig, device=DEFAULT_DEVICE,
                   dtype: torch.dtype | None = None) -> tuple[dict, dict]:
    """The JAX package's ``(trainable, frozen)`` trees, as numpy arrays, →
    the port's trees of tensors on ``device`` (the card unless the caller
    asks for the CPU).  ``dtype`` casts the floating leaves (None keeps each
    leaf's dtype)."""
    device = resolve_device(device)
    tr = tree_map(lambda a: _tensor(a, device, dtype), trainable)
    fz = tree_map(lambda a: _tensor(a, device, dtype), frozen)
    _check_gpt2(fz["gpt"] if "gpt" in fz else tr["gpt"], cfg.gpt2)
    return tr, fz


def to_numpy(trainable: dict, frozen: dict) -> tuple[dict, dict]:
    """The inverse of :func:`from_jax_numpy`: trees of numpy arrays (bfloat16
    tensors come back as float32)."""

    def arr(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return tree_map(arr, trainable), tree_map(arr, frozen)


# ---------------------------------------------------------------------------
# Reference state-dict names
# ---------------------------------------------------------------------------

def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 CPU copy (or view) of a parameter or state-dict tensor."""
    return t.detach().to("cpu", torch.float32).contiguous()


def _strip_prefix(sd: Mapping, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)


def _ln(sd: Mapping, name: str) -> dict:
    return {"scale": _f32(sd[f"{name}.weight"]), "bias": _f32(sd[f"{name}.bias"])}


def _linear(sd: Mapping, name: str, transpose: bool) -> dict:
    w = _f32(sd[f"{name}.weight"])
    p = {"w": (w.t() if transpose else w).contiguous()}
    if sd.get(f"{name}.bias") is not None:
        p["b"] = _f32(sd[f"{name}.bias"])
    return p


def port_gpt2(state_dict: Mapping, cfg: GPT2Config) -> dict:
    """HF ``GPT2LMHeadModel``/``GPT2Model`` state dict → the port's GPT-2
    params (keys with or without ``transformer.``; the tied ``lm_head`` and
    the causal-mask buffers are dropped)."""
    sd = _strip_prefix(dict(state_dict), "transformer.")
    blocks = []
    for i in range(cfg.n_layer):
        h = f"h.{i}"
        blocks.append({
            "ln_1": _ln(sd, f"{h}.ln_1"),
            "attn": {"c_attn": _linear(sd, f"{h}.attn.c_attn", transpose=False),
                     "c_proj": _linear(sd, f"{h}.attn.c_proj", transpose=False)},
            "ln_2": _ln(sd, f"{h}.ln_2"),
            "mlp": {"c_fc": _linear(sd, f"{h}.mlp.c_fc", transpose=False),
                    "c_proj": _linear(sd, f"{h}.mlp.c_proj", transpose=False)},
        })
    return {"wte": _f32(sd["wte.weight"]), "wpe": _f32(sd["wpe.weight"]),
            "ln_f": _ln(sd, "ln_f"), "blocks": stack_blocks(blocks)}


def export_gpt2(params: dict) -> dict[str, torch.Tensor]:
    """Inverse of :func:`port_gpt2`: HF names with ``transformer.`` and the
    tied ``lm_head.weight``."""
    out = {
        "transformer.wte.weight": _f32(params["wte"]),
        "transformer.wpe.weight": _f32(params["wpe"]),
        "transformer.ln_f.weight": _f32(params["ln_f"]["scale"]),
        "transformer.ln_f.bias": _f32(params["ln_f"]["bias"]),
        "lm_head.weight": _f32(params["wte"]),
    }
    b = params["blocks"]
    for i in range(b["ln_1"]["scale"].shape[0]):
        h = f"transformer.h.{i}"
        for ln in ("ln_1", "ln_2"):
            out[f"{h}.{ln}.weight"] = _f32(b[ln]["scale"][i])
            out[f"{h}.{ln}.bias"] = _f32(b[ln]["bias"][i])
        for group, name in (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
                            ("mlp", "c_proj")):
            out[f"{h}.{group}.{name}.weight"] = _f32(b[group][name]["w"][i])
            out[f"{h}.{group}.{name}.bias"] = _f32(b[group][name]["b"][i])
    return out


def port_mlp_mapping(state_dict: Mapping, cfg: MLPMappingConfig) -> dict:
    """Reference ``MLPMappingNetwork`` state dict (``model.0`` / ``model.2``
    Linear layers) → the MLP mapper's params."""
    sd = _strip_prefix(dict(state_dict), "mapping_network.")
    return {"fc1": _linear(sd, "model.0", transpose=True),
            "fc2": _linear(sd, "model.2", transpose=True)}


def export_mlp_mapping(params: dict) -> dict[str, torch.Tensor]:
    prefix = "mapping_network."
    return {
        f"{prefix}model.0.weight": _f32(params["fc1"]["w"].t()),
        f"{prefix}model.0.bias": _f32(params["fc1"]["b"]),
        f"{prefix}model.2.weight": _f32(params["fc2"]["w"].t()),
        f"{prefix}model.2.bias": _f32(params["fc2"]["b"]),
    }


def port_transformer_mapping(state_dict: Mapping, cfg: TransformerMappingConfig) -> dict:
    """Reference ``TransformerMappingNetwork`` state dict (``linear``,
    ``prefix_const``, ``transformer.layers.{i}.self_attn.in_proj_*``,
    ``out_proj``, ``linear1/2``, ``norm1/2``) → the transformer mapper's params."""
    sd = _strip_prefix(dict(state_dict), "mapping_network.")
    params: dict = {"linear": _linear(sd, "linear", transpose=True),
                    "prefix_const": _f32(sd["prefix_const"]), "layers": []}
    for i in range(cfg.num_layers):
        t = f"transformer.layers.{i}"
        params["layers"].append({
            "ln1": _ln(sd, f"{t}.norm1"),
            "attn": {
                "in_proj": {"w": _f32(sd[f"{t}.self_attn.in_proj_weight"]).t().contiguous(),
                            "b": _f32(sd[f"{t}.self_attn.in_proj_bias"])},
                "out_proj": _linear(sd, f"{t}.self_attn.out_proj", transpose=True),
            },
            "ln2": _ln(sd, f"{t}.norm2"),
            "fc1": _linear(sd, f"{t}.linear1", transpose=True),
            "fc2": _linear(sd, f"{t}.linear2", transpose=True),
        })
    return params


def export_transformer_mapping(params: dict) -> dict[str, torch.Tensor]:
    prefix = "mapping_network."
    out = {
        f"{prefix}linear.weight": _f32(params["linear"]["w"].t()),
        f"{prefix}linear.bias": _f32(params["linear"]["b"]),
        f"{prefix}prefix_const": _f32(params["prefix_const"]),
    }
    for i, lp in enumerate(params["layers"]):
        t = f"{prefix}transformer.layers.{i}"
        out[f"{t}.self_attn.in_proj_weight"] = _f32(lp["attn"]["in_proj"]["w"].t())
        out[f"{t}.self_attn.in_proj_bias"] = _f32(lp["attn"]["in_proj"]["b"])
        out[f"{t}.self_attn.out_proj.weight"] = _f32(lp["attn"]["out_proj"]["w"].t())
        out[f"{t}.self_attn.out_proj.bias"] = _f32(lp["attn"]["out_proj"]["b"])
        out[f"{t}.norm1.weight"] = _f32(lp["ln1"]["scale"])
        out[f"{t}.norm1.bias"] = _f32(lp["ln1"]["bias"])
        out[f"{t}.norm2.weight"] = _f32(lp["ln2"]["scale"])
        out[f"{t}.norm2.bias"] = _f32(lp["ln2"]["bias"])
        out[f"{t}.linear1.weight"] = _f32(lp["fc1"]["w"].t())
        out[f"{t}.linear1.bias"] = _f32(lp["fc1"]["b"])
        out[f"{t}.linear2.weight"] = _f32(lp["fc2"]["w"].t())
        out[f"{t}.linear2.bias"] = _f32(lp["fc2"]["b"])
    return out


# ---------------------------------------------------------------------------
# Vision towers: the JAX package's trees, and the published state dicts
# ---------------------------------------------------------------------------

def vision_from_jax_numpy(params: dict, device=DEFAULT_DEVICE,
                          dtype: torch.dtype | None = None) -> dict:
    """A JAX vision tower's parameter tree (CLIP, ViT or DINOv3), as numpy
    arrays, → the port's tree of tensors on ``device`` (the card unless the
    caller asks for the CPU); ``dtype`` casts the floating leaves."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device, dtype), params)


def _conv_as_matmul(w: torch.Tensor) -> torch.Tensor:
    """A stride-patch conv weight (D, 3, P, P) → the (3·P·P, D) matmul layout."""
    return _f32(w).reshape(w.shape[0], -1).t().contiguous()


def _clip_encoder_layers(sd: Mapping, prefix: str, n_layers: int) -> dict:
    layers = []
    for i in range(n_layers):
        p = f"{prefix}encoder.layers.{i}"
        layers.append({
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {"q": _linear(sd, f"{p}.self_attn.q_proj", transpose=True),
                     "k": _linear(sd, f"{p}.self_attn.k_proj", transpose=True),
                     "v": _linear(sd, f"{p}.self_attn.v_proj", transpose=True),
                     "out": _linear(sd, f"{p}.self_attn.out_proj", transpose=True)},
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1", transpose=True),
                    "fc2": _linear(sd, f"{p}.mlp.fc2", transpose=True)},
        })
    return stack_blocks(layers)


def port_clip_vision(state_dict: Mapping, cfg) -> dict:
    """HF CLIP vision tower + visual projection (a full ``CLIPModel`` or a
    ``CLIPVisionModelWithProjection`` state dict) → :mod:`models.clip`'s
    tree.  HF's historical key ``pre_layrnorm`` is read as such."""
    sd = dict(state_dict)
    pre = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
           else "vision_model.pre_layernorm")
    return {
        "class_embedding": _f32(sd["vision_model.embeddings.class_embedding"]),
        "patch_embedding": _conv_as_matmul(sd["vision_model.embeddings.patch_embedding.weight"]),
        "position_embedding": _f32(sd["vision_model.embeddings.position_embedding.weight"]),
        "pre_layernorm": _ln(sd, pre),
        "layers": _clip_encoder_layers(sd, "vision_model.", cfg.num_hidden_layers),
        "post_layernorm": _ln(sd, "vision_model.post_layernorm"),
        "visual_projection": {"w": _f32(sd["visual_projection.weight"]).t().contiguous()},
    }


def port_vit(state_dict: Mapping, cfg) -> dict:
    """HF ``ViTModel`` state dict (with or without ``vit.``) → :mod:`models.vit`'s
    tree."""
    sd = _strip_prefix(dict(state_dict), "vit.")
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}"
        layers.append({
            "ln_before": _ln(sd, f"{p}.layernorm_before"),
            "attn": {"q": _linear(sd, f"{p}.attention.attention.query", transpose=True),
                     "k": _linear(sd, f"{p}.attention.attention.key", transpose=True),
                     "v": _linear(sd, f"{p}.attention.attention.value", transpose=True),
                     "out": _linear(sd, f"{p}.attention.output.dense", transpose=True)},
            "ln_after": _ln(sd, f"{p}.layernorm_after"),
            "mlp": {"fc1": _linear(sd, f"{p}.intermediate.dense", transpose=True),
                    "fc2": _linear(sd, f"{p}.output.dense", transpose=True)},
        })
    return {
        "cls_token": _f32(sd["embeddings.cls_token"]),
        "patch_embedding": {
            "w": _conv_as_matmul(sd["embeddings.patch_embeddings.projection.weight"]),
            "b": _f32(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "position_embeddings": _f32(sd["embeddings.position_embeddings"]),
        "layers": stack_blocks(layers),
        "final_layernorm": _ln(sd, "layernorm"),
        "pooler": _linear(sd, "pooler.dense", transpose=True),
    }


def port_dinov3_backbone(state_dict: Mapping, cfg) -> dict:
    """facebookresearch/dinov3 hub backbone state dict (``backbone.`` stripped
    when present) → :mod:`models.dino`'s tree; the dino.txt head is a zero
    placeholder until :func:`port_dinotxt_head` fills it."""
    sd = _strip_prefix(dict(state_dict), "backbone.")
    conv = sd["patch_embed.proj.weight"]
    d = conv.shape[0]
    reg_key = "storage_tokens" if "storage_tokens" in sd else "register_tokens"
    blocks = []
    for i in range(cfg.num_hidden_layers):
        p = f"blocks.{i}"
        blocks.append({
            "ln1": _ln(sd, f"{p}.norm1"),
            "attn": {"qkv": _linear(sd, f"{p}.attn.qkv", transpose=True),
                     "proj": _linear(sd, f"{p}.attn.proj", transpose=True)},
            "gamma1": _f32(sd[f"{p}.ls1.gamma"]),
            "ln2": _ln(sd, f"{p}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1", transpose=True),
                    "fc2": _linear(sd, f"{p}.mlp.fc2", transpose=True)},
            "gamma2": _f32(sd[f"{p}.ls2.gamma"]),
        })
    return {
        "patch_embedding": {"w": _conv_as_matmul(conv), "b": _f32(sd["patch_embed.proj.bias"])},
        "cls_token": _f32(sd["cls_token"]).reshape(1, 1, d),
        "register_tokens": _f32(sd[reg_key]).reshape(1, -1, d),
        "blocks": stack_blocks(blocks),
        "norm": _ln(sd, "norm"),
        "head": {"w": torch.zeros((2 * d, cfg.text_embed_dim), dtype=torch.float32)},
    }


def port_dinotxt_head(params: dict, state_dict: Mapping, cfg) -> dict:
    """Attach the dino.txt vision head (``visual_head`` / ``image_projection``
    / ``vision_head`` linear) to a ported backbone tree."""
    sd = dict(state_dict)
    for key in ("visual_head.weight", "image_projection.weight", "vision_head.weight"):
        if key in sd:
            return dict(params, head={"w": _f32(sd[key]).t().contiguous()})
    raise KeyError(
        "dino.txt vision head weight not found; expected one of visual_head/image_projection/"
        f"vision_head among {sorted(k for k in sd if 'head' in k or 'proj' in k)[:20]}")
