"""The weight bridge between the JAX package and the port.

The port keeps the JAX package's parameter trees as they are (nested dicts,
a list for the transformer mapper's layers, GPT-2 blocks stacked on a
leading layer dim, ``(in, out)`` matmul weights), so crossing over is a
leaf-by-leaf copy.  The caller turns the JAX trees into numpy first
(``jax.tree.map(np.asarray, tree)``): the port never imports jax.

A bfloat16 leaf arrives as an ``ml_dtypes`` bfloat16 numpy array and becomes
a torch bfloat16 tensor bit for bit; :func:`to_numpy` returns bfloat16
tensors as float32 arrays, which hold the same values exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.tree import tree_map
from gpt2_image_captioning_tpu_torch.models.captioner import CaptionerConfig
from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config


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


def from_jax_numpy(trainable: dict, frozen: dict, cfg: CaptionerConfig, device="cpu",
                   dtype: torch.dtype | None = None) -> tuple[dict, dict]:
    """The JAX package's ``(trainable, frozen)`` trees, as numpy arrays, →
    the port's trees of tensors on ``device``.  ``dtype`` casts the floating
    leaves (None keeps each leaf's dtype)."""
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
