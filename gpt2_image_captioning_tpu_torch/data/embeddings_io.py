"""Embedding-file interchange — the counterpart of
``gpt2_image_captioning_tpu/data/embeddings_io.py``.

The interchange format is the reference's ``.pt`` file, ``{"filenames":
list[str], "embeddings": FloatTensor(N, D)}`` (CPU tensors, torch
serialisation), byte-compatible with the JAX package's; ``.npz`` (pure
numpy) is chosen by the file extension.
"""

from __future__ import annotations

import numpy as np
import torch


def save_embeddings(path: str, filenames: list[str], embeddings) -> None:
    """Write ``filenames`` and their (N, D) embeddings (a numpy array or a
    tensor on any device) as float32."""
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.detach().cpu().float().numpy()
    embeddings = np.ascontiguousarray(embeddings, dtype=np.float32)
    if path.endswith(".npz"):
        np.savez(path, filenames=np.array(filenames, dtype=object), embeddings=embeddings)
        return
    torch.save({"filenames": list(filenames), "embeddings": torch.from_numpy(embeddings)}, path)


def load_embeddings(path: str) -> tuple[list[str], np.ndarray]:
    """(filenames, (N, D) float32 embeddings) from a ``.pt`` or ``.npz`` file."""
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=True)
        return list(data["filenames"]), np.asarray(data["embeddings"], dtype=np.float32)
    data = torch.load(path, map_location="cpu", weights_only=False)
    emb = data["embeddings"]
    if isinstance(emb, torch.Tensor):
        emb = emb.float().numpy()
    return list(data["filenames"]), np.asarray(emb, dtype=np.float32)
