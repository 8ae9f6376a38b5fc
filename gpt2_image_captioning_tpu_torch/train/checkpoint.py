"""Captioner checkpoints — the counterpart of ``save_captioner`` /
``load_captioner`` in ``gpt2_image_captioning_tpu/train/checkpoint.py``.

Two formats, chosen by extension, both holding exactly the trainable tree
(frozen GPT-2 weights are left out, as the reference's ``save_parameters``
does):

- ``.npz`` — the JAX package's native format: flattened tree paths
  (``mapping.layers.0.ln1.scale``) → float32 arrays;
- ``.pt`` — the reference's torch format and names (``mapping_network.*``,
  ``task_prefix_embeds``, ``gpt.*``), so a checkpoint moves between the
  reference, the JAX package and the port in every direction.

Loading applies the JAX package's checks: unexpected keys raise, and so do
missing ones (the frozen ``gpt.*`` weights are never looked for).  Loaded
tensors are float32 on the device of the ``trainable`` tree they replace.
The orbax format is TPU-only and left behind.
"""

from __future__ import annotations

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.tree import (
    flatten_with_paths,
    tree_leaves,
    tree_map,
    unflatten_from_paths,
)
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.models.mapping import MLPMappingConfig


def _to_reference_state_dict(trainable: dict, cfg) -> dict[str, torch.Tensor]:
    if isinstance(cfg.mapping, MLPMappingConfig):
        sd = porting.export_mlp_mapping(trainable["mapping"])
    else:
        sd = porting.export_transformer_mapping(trainable["mapping"])
    if "task_prefix" in trainable:
        sd["task_prefix_embeds"] = trainable["task_prefix"].detach().to("cpu", torch.float32)
    if "gpt" in trainable:
        sd.update({f"gpt.{k}": v for k, v in porting.export_gpt2(trainable["gpt"]).items()})
    return sd


def _from_reference_state_dict(sd: dict, trainable: dict, cfg) -> dict:
    unexpected = [k for k in sd if not k.startswith(("mapping_network.", "task_prefix_embeds",
                                                     "gpt."))]
    if unexpected:
        raise ValueError(f"Unexpected keys found in the checkpoint: {unexpected}")
    out = dict(trainable)
    if isinstance(cfg.mapping, MLPMappingConfig):
        out["mapping"] = porting.port_mlp_mapping(sd, cfg.mapping)
    else:
        out["mapping"] = porting.port_transformer_mapping(sd, cfg.mapping)
    if "task_prefix" in trainable:
        if "task_prefix_embeds" not in sd:
            raise ValueError("Missing keys found in the checkpoint: ['task_prefix_embeds']")
        out["task_prefix"] = sd["task_prefix_embeds"].to("cpu", torch.float32)
    if "gpt" in trainable:
        gpt_sd = {k[len("gpt."):]: v for k, v in sd.items() if k.startswith("gpt.")}
        if not gpt_sd:
            raise ValueError(
                "Missing keys found in the checkpoint that are not from frozen GPT weights: "
                "['gpt.*']"
            )
        out["gpt"] = porting.port_gpt2(gpt_sd, cfg.gpt2)
    return out


def save_captioner(path: str, trainable: dict, cfg) -> None:
    """Save the trainable parameters (everything except frozen GPT-2)."""
    if path.endswith(".pt"):
        torch.save(_to_reference_state_dict(trainable, cfg), path)
    else:
        flat = flatten_with_paths(trainable)
        np.savez(path, **{k: v.detach().to("cpu", torch.float32).numpy() for k, v in flat.items()})


def load_captioner(path: str, trainable: dict, cfg) -> dict:
    """Load a ``.pt`` (reference names, from the reference, the JAX package or
    the port) or an ``.npz`` checkpoint into a tree shaped like ``trainable``."""
    device = tree_leaves(trainable)[0].device
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        loaded = _from_reference_state_dict(sd, trainable, cfg)
    else:
        with np.load(path, allow_pickle=False) as data:
            flat = {k: torch.from_numpy(data[k].astype(np.float32)) for k in data.files}
        cur = set(flatten_with_paths(trainable))
        unexpected, missing = sorted(set(flat) - cur), sorted(cur - set(flat))
        if unexpected:
            raise ValueError(f"Unexpected keys found in the checkpoint: {unexpected}")
        if missing:
            raise ValueError(f"Missing keys found in the checkpoint: {missing}")
        loaded = unflatten_from_paths(flat)
    return tree_map(lambda t: t.to(device), loaded)
