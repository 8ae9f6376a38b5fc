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
:func:`save_pytree` / :func:`load_pytree` are the generic ``.npz`` format
underneath (the optimizer's ``optimizer_epoch_{n}.npz`` too).  The orbax
format is TPU-only and left behind.
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


def save_pytree(path: str, tree) -> None:
    """A tree of tensors or arrays → ``.npz`` under its flattened paths
    (``mu.mapping.layers.0.ln1.scale``), the JAX package's ``save_pytree``
    format; bfloat16 tensors are written as float32."""
    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    np.savez(path, **{k: arr(v) for k, v in flatten_with_paths(tree).items()})


def load_pytree(path: str):
    """The tree of :func:`save_pytree` (or of the JAX package's), as CPU
    tensors in the stored dtypes."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten_from_paths({k: torch.from_numpy(data[k]) for k in data.files})


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
        save_pytree(path, tree_map(lambda t: t.detach().to("cpu", torch.float32), trainable))


def load_captioner(path: str, trainable: dict, cfg) -> dict:
    """Load a ``.pt`` (reference names, from the reference, the JAX package or
    the port) or an ``.npz`` checkpoint into a tree shaped like ``trainable``."""
    device = tree_leaves(trainable)[0].device
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        loaded = _from_reference_state_dict(sd, trainable, cfg)
    else:
        flat = {k: v.float() for k, v in flatten_with_paths(load_pytree(path)).items()}
        cur = set(flatten_with_paths(trainable))
        unexpected, missing = sorted(set(flat) - cur), sorted(cur - set(flat))
        if unexpected:
            raise ValueError(f"Unexpected keys found in the checkpoint: {unexpected}")
        if missing:
            raise ValueError(f"Missing keys found in the checkpoint: {missing}")
        loaded = unflatten_from_paths(flat)
    return tree_map(lambda t: t.to(device), loaded)
