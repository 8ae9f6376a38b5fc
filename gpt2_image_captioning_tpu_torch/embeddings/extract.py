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
card, where PyTorch launches eagerly, and is not ported; the CLI accepts
``--device-chunks`` and ignores it, so one command line runs in both
packages.

``mesh=`` (a dp :class:`core.mesh.Mesh`, the same call on every rank): each
rank reads every batch, encodes its contiguous shard of it, and one gather
at the end assembles the embeddings in file order on every rank; rank 0
writes the artifact.  (Each rank decodes every image on the host: the
loader's batches are the unit of the split.)

``python -m gpt2_image_captioning_tpu_torch.embeddings.extract --encoder
clip|vit|dino --image-dir DIR --output FILE [--checkpoint FILE]`` is the
JAX package's CLI: the production tower (CLIP ViT-B/32, ViT-B/16, DINOv3
ViT-L/16 with the dino.txt head) from a local checkpoint through
``models/porting.py``, or random-init without one; nothing is downloaded.
Under ``torchrun --nproc-per-node N`` it extracts over a dp mesh of N ranks.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.mesh import barrier
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
    ``output_path`` when given.  Padding rows of the last batch are dropped.
    Under a ``mesh`` (on its device) each rank encodes its rows of every
    batch, padded by repeating the last image to a multiple of dp
    (module docstring); its meshes must be dp-only, as the JAX package's."""
    if mesh is not None and mesh.tp != 1:
        raise ValueError("extraction meshes must be dp-only (tp=1)")
    device = resolve_device(device) if mesh is None else mesh.device
    names: list[str] = []
    outs: list[torch.Tensor] = []
    batches: list[tuple[int, int]] = []  # (rows a rank, real rows) of each batch
    n_images = len(loader.dir) if hasattr(loader, "dir") else None
    print(f"Starting {desc} embedding extraction"
          + (f" for {n_images} images..." if n_images is not None else "..."))
    t0 = time.perf_counter()

    with torch.no_grad():
        for batch_names, batch_u8, _valid in loader:
            if mesh is not None:
                per = -(-len(batch_u8) // mesh.dp)
                batch_u8 = np.concatenate(
                    [batch_u8, np.repeat(batch_u8[-1:], per * mesh.dp - len(batch_u8), axis=0)])
                batch_u8 = batch_u8[mesh.rank * per:(mesh.rank + 1) * per]
                batches.append((per, len(batch_names)))
            u8 = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device)
            out = encode_u8(u8)
            outs.append(out if mesh is not None else out[: len(batch_names)])
            names.extend(batch_names)
    if mesh is not None and outs:
        outs = _assemble(mesh, torch.cat(outs), batches)
    embeddings = (torch.cat(outs).float().cpu().numpy() if outs
                  else np.zeros((0, 0), np.float32))  # one copy back, at the end
    dt = time.perf_counter() - t0
    print(f"{desc}: {len(names)} images in {dt:.1f}s ({len(names) / max(dt, 1e-9):.1f} img/s)")
    if output_path and (mesh is None or mesh.is_main):
        print(f"Saving {embeddings.shape[0]} embeddings to {output_path}...")
        save_embeddings(output_path, names, embeddings)
    barrier(mesh)
    return names, embeddings


def _assemble(mesh, local: torch.Tensor, batches: list[tuple[int, int]]) -> list[torch.Tensor]:
    """Every rank's rows of every batch (``local``: this rank's, batch after
    batch) gathered once and put back in file order → each batch's real
    rows."""
    from gpt2_image_captioning_tpu_torch.parallel.collectives import all_gather_batch

    blocks = all_gather_batch(mesh, local).reshape(mesh.dp, local.shape[0], -1)
    out, offset = [], 0
    for per, n in batches:
        out.append(blocks[:, offset:offset + per].reshape(mesh.dp * per, -1)[:n])
        offset += per
    return out


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


def _load_state_dict(path: str):
    """A checkpoint's state dict: safetensors, or a torch file (its
    ``state_dict`` entry when it has one)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def main(argv: list[str] | None = None) -> None:
    """``python -m gpt2_image_captioning_tpu_torch.embeddings.extract``: the
    JAX package's extraction CLI (module docstring), plus ``--device``."""
    import argparse

    from gpt2_image_captioning_tpu_torch.core.mesh import create_mesh, init_distributed, launched
    from gpt2_image_captioning_tpu_torch.core.tree import tree_map
    from gpt2_image_captioning_tpu_torch.models import clip, dino, porting, vit

    p = argparse.ArgumentParser(description="Extract image embeddings")
    p.add_argument("--encoder", choices=["clip", "vit", "dino"], required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--output", required=True, help=".pt or .npz embeddings artifact")
    p.add_argument("--checkpoint", default=None,
                   help="a local torch or safetensors file with the tower's weights; "
                        "random init if omitted")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--device-chunks", type=int, default=1,
                   help="accepted and ignored: the JAX package's dispatch amortisation")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="where the tower runs (default: the card; 'cpu' for its plain path)")
    args = p.parse_args(argv)

    mesh = None
    if launched():
        init_distributed(device=args.device)
        mesh = create_mesh(device=args.device)
    device = resolve_device(args.device) if mesh is None else mesh.device
    sd = _load_state_dict(args.checkpoint) if args.checkpoint else None
    generator = torch.Generator().manual_seed(0)
    if args.encoder == "clip":
        cfg = clip.CLIPVisionConfig.vit_b32()
        params = (porting.port_clip_vision(sd, cfg) if sd is not None
                  else clip.init_vision(generator, cfg, device))
    elif args.encoder == "vit":
        cfg = vit.ViTConfig.base_patch16_224()
        params = porting.port_vit(sd, cfg) if sd is not None else vit.init(generator, cfg, device)
    else:
        cfg = dino.DINOv3Config.vitl16()
        if sd is not None:
            params = porting.port_dinotxt_head(porting.port_dinov3_backbone(sd, cfg), sd, cfg)
        else:
            params = dino.init(generator, cfg, device)
    params = tree_map(lambda t: t.to(device), params)
    fn = {"clip": extract_clip_embeddings, "vit": extract_vit_embeddings,
          "dino": extract_dino_embeddings}[args.encoder]
    fn(args.image_dir, args.output, params, cfg, args.batch_size, args.num_workers, mesh=mesh)
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
