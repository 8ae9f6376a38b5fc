"""Indexing pipelines: embedding artifacts → vector stores on disk — the
counterpart of ``gpt2_image_captioning_tpu/retrieval/indexing.py`` (the
reference's FAISS and ObjectBox indexing pipelines' roles): read the image
``.pt`` and the grouped caption ``.pt``, build the chosen store, save it.
CLI: ``python -m gpt2_image_captioning_tpu_torch.retrieval.indexing --help``.
"""

from __future__ import annotations

import argparse

import torch

from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings


def _load_inputs(image_embeddings_path: str, caption_embeddings_path: str):
    filenames, image_emb = load_embeddings(image_embeddings_path)
    caption_entries = torch.load(caption_embeddings_path, map_location="cpu",
                                 weights_only=False)
    return filenames, image_emb, caption_entries


def run_indexing_pipeline(
    image_embeddings_path: str,
    caption_embeddings_path: str,
    output_dir: str,
    backend: str = "hnsw",
    M: int = 32,
    ef_construction: int = 200,
    ef_search: int = 64,
):
    """Build and save the in-memory dual-index store (``hnsw`` or ``flat``)."""
    from gpt2_image_captioning_tpu_torch.retrieval.store import create_store

    filenames, image_emb, caption_entries = _load_inputs(
        image_embeddings_path, caption_embeddings_path)
    print(f"Indexing {len(filenames)} images ({backend}, M={M}, efC={ef_construction})...")
    store = create_store(filenames, image_emb, caption_entries, backend=backend, M=M,
                         ef_construction=ef_construction, ef_search=ef_search)
    store.save(output_dir)
    print(f"Store saved to {output_dir} "
          f"({len(store.image_index)} images, {len(store.caption_index)} captions)")
    return store


def run_persistent_indexing_pipeline(
    image_embeddings_path: str,
    caption_embeddings_path: str,
    output_dir: str,
    M: int = 32,
    ef_construction: int = 200,
    ef_search: int = 64,
):
    """Build and open the persistent memory-mapped store (with the
    precomputed caption↔image similarities)."""
    from gpt2_image_captioning_tpu_torch.retrieval.store import create_persistent_store

    filenames, image_emb, caption_entries = _load_inputs(
        image_embeddings_path, caption_embeddings_path)
    print(f"Building persistent store for {len(filenames)} images...")
    store = create_persistent_store(output_dir, filenames, image_emb, caption_entries, M=M,
                                    ef_construction=ef_construction, ef_search=ef_search)
    print(f"Persistent store ready at {output_dir}")
    return store


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description="Build a retrieval vector store")
    p.add_argument("--image-embeddings", required=True)
    p.add_argument("--caption-embeddings", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--backend", default="hnsw", choices=["hnsw", "flat", "persistent"])
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--ef-construction", type=int, default=200)
    p.add_argument("--ef-search", type=int, default=64)
    args = p.parse_args(argv)
    if args.backend == "persistent":
        run_persistent_indexing_pipeline(
            args.image_embeddings, args.caption_embeddings, args.output_dir,
            args.M, args.ef_construction, args.ef_search)
    else:
        run_indexing_pipeline(
            args.image_embeddings, args.caption_embeddings, args.output_dir,
            args.backend, args.M, args.ef_construction, args.ef_search)


if __name__ == "__main__":
    main()
