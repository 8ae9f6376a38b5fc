"""Batched embedding extraction for the three vision towers — the
counterpart of ``gpt2_image_captioning_tpu/embeddings/extract.py``.

Host threads decode and resize (``data.images`` or the C++ pipeline of
``data.native_pipe``); each fixed-shape uint8 batch goes to the card, where
the tower's uint8 entry point embeds its patches with the patch-embed kernel
and runs the tower; the embeddings stay on the card until the end of the
run, then one copy brings them back.  The output is the reference's
interchange file ``{"filenames": list[str], "embeddings": (N, D)}``.

The JAX package's ``device_chunks`` (one dispatched scan over C host
batches, to amortise a per-dispatch cost) has nothing to amortise on one
card, where PyTorch launches eagerly, and is not ported.  ``mesh=`` refuses:
parallelism is not ported (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import BF16, Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves
from gpt2_image_captioning_tpu_torch.data.embeddings_io import save_embeddings
from gpt2_image_captioning_tpu_torch.data.images import ImageBatchLoader
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import (
    SPECS, PreprocessSpec, make_host_preprocess,
)


def _make_loader(image_dir: str, spec: PreprocessSpec, batch_size: int, num_workers: int):
    """The C++ decode pipeline when it is built, PIL threads otherwise."""
    from gpt2_image_captioning_tpu_torch.data import native_pipe

    if native_pipe.available():
        return native_pipe.NativeImageBatchLoader(image_dir, spec, batch_size=batch_size,
                                                  num_workers=num_workers)
    return ImageBatchLoader(image_dir, preprocess=make_host_preprocess(spec),
                            batch_size=batch_size, num_workers=num_workers)


def _run_extraction(loader, output_path: str | None, encode_u8: Callable, desc: str,
                    mesh=None, device=DEFAULT_DEVICE) -> tuple[list[str], np.ndarray]:
    """Stream ``loader``'s ``(names, batch_u8 (B, S, S, 3), valid)`` batches
    through ``encode_u8`` (uint8 tensor on ``device`` → (B, D) embeddings)
    and return (names, (N, D) float32 embeddings), written to
    ``output_path`` when given.  Padding rows of the last batch are dropped."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device extraction is not ported yet (ROADMAP.md, queue 1: parallelism)")
    device = resolve_device(device)
    names: list[str] = []
    outs: list[torch.Tensor] = []
    n_images = len(loader.dir) if hasattr(loader, "dir") else None
    print(f"Starting {desc} embedding extraction"
          + (f" for {n_images} images..." if n_images is not None else "..."))
    t0 = time.perf_counter()

    with torch.no_grad():
        for batch_names, batch_u8, _valid in loader:
            u8 = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device)
            outs.append(encode_u8(u8)[: len(batch_names)])
            names.extend(batch_names)
    embeddings = (torch.cat(outs).float().cpu().numpy() if outs
                  else np.zeros((0, 0), np.float32))  # one copy back, at the end
    dt = time.perf_counter() - t0
    print(f"{desc}: {len(names)} images in {dt:.1f}s ({len(names) / max(dt, 1e-9):.1f} img/s)")
    if output_path:
        print(f"Saving {embeddings.shape[0]} embeddings to {output_path}...")
        save_embeddings(output_path, names, embeddings)
    return names, embeddings


def _extract(encoder: str, image_dir: str, output_path: str | None, params: dict, cfg,
             batch_size: int, num_workers: int, policy: Policy, mesh, use_kernels: bool | None,
             desc: str) -> tuple[list[str], np.ndarray]:
    from gpt2_image_captioning_tpu_torch.models import clip, dino, vit

    module = {"clip": clip, "vit": vit, "dino": dino}[encoder]
    spec = SPECS[encoder]
    device = tree_leaves(params)[0].device

    def encode(batch_u8):
        return module.encode_image_u8(params, cfg, batch_u8, spec, policy=policy, normalize=True,
                                      use_kernels=use_kernels)

    loader = _make_loader(image_dir, spec, batch_size, num_workers)
    return _run_extraction(loader, output_path, encode, desc, mesh, device)


def extract_clip_embeddings(image_dir: str, output_path: str | None, clip_params: dict, clip_cfg,
                            batch_size: int = 64, num_workers: int = 4, policy: Policy = BF16,
                            mesh=None, use_kernels: bool | None = None
                            ) -> tuple[list[str], np.ndarray]:
    """CLIP image features, L2-normalised, 512-d, on the device of
    ``clip_params``."""
    return _extract("clip", image_dir, output_path, clip_params, clip_cfg, batch_size,
                    num_workers, policy, mesh, use_kernels, "CLIP")


def extract_vit_embeddings(image_dir: str, output_path: str | None, vit_params: dict, vit_cfg,
                           batch_size: int = 64, num_workers: int = 4, policy: Policy = BF16,
                           mesh=None, use_kernels: bool | None = None
                           ) -> tuple[list[str], np.ndarray]:
    """HF ViT pooler ([CLS]) features, L2-normalised, 768-d."""
    return _extract("vit", image_dir, output_path, vit_params, vit_cfg, batch_size, num_workers,
                    policy, mesh, use_kernels, "ViT")


def extract_dino_embeddings(image_dir: str, output_path: str | None, dino_params: dict, dino_cfg,
                            batch_size: int = 64, num_workers: int = 4, policy: Policy = BF16,
                            mesh=None, use_kernels: bool | None = None
                            ) -> tuple[list[str], np.ndarray]:
    """DINOv3 + dino.txt image features, L2-normalised."""
    return _extract("dino", image_dir, output_path, dino_params, dino_cfg, batch_size,
                    num_workers, policy, mesh, use_kernels, "DINO")
