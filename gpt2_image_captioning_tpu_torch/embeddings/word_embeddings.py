"""Caption text embeddings for the retrieval stores — the counterpart of
``gpt2_image_captioning_tpu/embeddings/word_embeddings.py``.

Every COCO caption is encoded by the CLIP text tower (:func:`models.clip.encode_text`,
its attention on the flash kernel on the card) and grouped by image filename
into the reference's artifact, ``[{"filenames": fname, "embeddings":
[{"caption_id", "embedding"}]}]`` saved with ``torch.save``, which either
package reads.  The JAX function encodes fixed-shape padded batches (one
compiled program); here each batch is encoded at its own size, the tail
batch unpadded, which gives the same rows.
"""

from __future__ import annotations

import json
import time
from typing import Any

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.precision import BF16, Policy


def map_caption_id_to_caption(annotations_path: str) -> dict[int, str]:
    """caption_id → caption text."""
    with open(annotations_path, "r") as f:
        coco = json.load(f)
    return {a["id"]: a["caption"] for a in coco["annotations"]}


def extract_caption_embeddings(
    annotations_path: str,
    output_path: str | None,
    text_params: dict,
    text_cfg,
    tokenizer,
    batch_size: int = 256,
    policy: Policy = BF16,
) -> list[dict[str, Any]]:
    """Encode every caption of ``annotations_path`` (L2-normalised features),
    grouped by image filename in first-seen order; saved as ``.pt`` when
    ``output_path`` is given.  The text tower runs where ``text_params``
    live.  Filenames come from the annotations' ``images`` (``file_name``),
    else COCO's zero-padded ``{id:012d}.jpg``."""
    from gpt2_image_captioning_tpu_torch.models import clip as CL

    with open(annotations_path, "r") as f:
        coco = json.load(f)
    id_to_fname = {im["id"]: im.get("file_name", f"{im['id']:012d}.jpg") for im in coco["images"]}
    anns = coco["annotations"]
    device = text_params["token_embedding"].device
    texts = [a["caption"] for a in anns]
    feats = np.zeros((len(texts), text_cfg.projection_dim), np.float32)
    t0 = time.perf_counter()
    with torch.no_grad():
        for start in range(0, len(texts), batch_size):
            chunk = texts[start: start + batch_size]
            ids = tokenizer(chunk)["input_ids"][:, : text_cfg.max_position_embeddings]
            out = CL.encode_text(text_params, text_cfg, torch.from_numpy(ids).to(device),
                                 policy=policy, normalize=True)
            feats[start: start + len(chunk)] = out.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"Encoded {len(texts)} captions in {dt:.1f}s ({len(texts) / max(dt, 1e-9):.1f} cap/s)")

    grouped: dict[str, list[dict[str, Any]]] = {}
    for a, vec in zip(anns, feats):
        grouped.setdefault(id_to_fname[a["image_id"]], []).append(
            {"caption_id": a["id"], "embedding": torch.from_numpy(vec.copy())})
    result = [{"filenames": f, "embeddings": entries} for f, entries in grouped.items()]
    if output_path:
        torch.save(result, output_path)
        print(f"Saved caption embeddings for {len(result)} images to {output_path}")
    return result


def main(argv: list[str] | None = None) -> None:
    """CLI: ``python -m gpt2_image_captioning_tpu_torch.embeddings.word_embeddings
    --annotations A --output O [--checkpoint CLIP.safetensors]`` — encode every
    caption of an annotations file on the card (random seeded weights
    without a checkpoint)."""
    import argparse

    from gpt2_image_captioning_tpu_torch.data.tokenizer import load_clip_tokenizer
    from gpt2_image_captioning_tpu_torch.models import clip as CL
    from gpt2_image_captioning_tpu_torch.models.porting import port_clip_text

    p = argparse.ArgumentParser(description="Extract caption text embeddings (CLIP)")
    p.add_argument("--annotations", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default=None, help="CLIP safetensors (full model)")
    p.add_argument("--batch-size", type=int, default=256)
    args = p.parse_args(argv)

    cfg = CL.CLIPTextConfig()
    if args.checkpoint:
        from safetensors.torch import load_file

        params = CL.on_device(port_clip_text(load_file(args.checkpoint), cfg))
    else:
        params = CL.init_text(torch.Generator().manual_seed(0), cfg)
    extract_caption_embeddings(args.annotations, args.output, params, cfg,
                               load_clip_tokenizer(), batch_size=args.batch_size)


if __name__ == "__main__":
    main()
