"""Host vector stores over the repository's C++ index — the counterpart of
``gpt2_image_captioning_tpu/retrieval/store.py``, with the same classes,
functions and on-disk formats, so either package opens the other's stores:

- :class:`VectorStore`: an image index and a caption index in memory (HNSW
  or flat), filename and caption metadata and a filename → caption-indices
  map, the reference's FAISS store's role:
  ``retrieve_images_by_vector_similarity`` (batch search, the self-match
  sim > 0.9999 filtered) and ``get_caption_embeddings`` (reconstructed,
  zero-padded);
- :class:`PersistentVectorStore`: a directory with the serialised HNSW image
  index, JSON metadata and memory-mapped embedding matrices, plus the
  precomputed caption↔image similarities, the reference's ObjectBox
  store's role, with ``retrieve_for_single_embedding``.

All of it is numpy on the host; the RAT train step prefetches its
retrievals a batch ahead (:func:`train.loop._prefetched`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.retrieval.hnsw import FlatIPIndex, HNSWIndex

SELF_MATCH_THRESHOLD = 0.9999


def _build_caption_side(
    image_filenames: Sequence[str], caption_entries: Sequence[dict[str, Any]]
):
    """Flatten grouped caption entries → (matrix, caption_ids, fname→indices)."""
    vecs, cap_ids = [], []
    by_fname: dict[str, list[int]] = {}
    for item in caption_entries:
        fname = item["filenames"]
        for e in item["embeddings"]:
            v = e["embedding"]
            if isinstance(v, torch.Tensor):
                v = v.float().numpy()
            by_fname.setdefault(fname, []).append(len(vecs))
            vecs.append(np.asarray(v, np.float32))
            cap_ids.append(int(e["caption_id"]))
    matrix = np.stack(vecs) if vecs else np.zeros((0, 1), np.float32)
    return matrix, np.asarray(cap_ids, np.int64), by_fname


class VectorStore:
    """In-memory image+caption indices with FAISS-store-parity operations."""

    def __init__(
        self,
        image_index,
        caption_index,
        image_filenames: list[str],
        caption_ids: np.ndarray,
        filename_to_caption_indices: dict[str, list[int]],
        caption_dim: int,
    ):
        self.image_index = image_index
        self.caption_index = caption_index
        self.image_filenames = list(image_filenames)
        self.caption_ids = caption_ids
        self.filename_to_caption_indices = filename_to_caption_indices
        self.caption_dim = caption_dim

    def retrieve_images_by_vector_similarity(
        self, query_vectors: np.ndarray, top_i: int
    ) -> list[list[tuple[str, float]]]:
        """Batch search; the query's own image (sim > 0.9999) is filtered
        (search depth top_i+1 to compensate, like the reference)."""
        scores, ids = self.image_index.search(np.asarray(query_vectors, np.float32), top_i + 1)
        out = []
        for row_s, row_i in zip(scores, ids):
            row = [
                (self.image_filenames[int(i)], float(s))
                for s, i in zip(row_s, row_i)
                if i >= 0 and s <= SELF_MATCH_THRESHOLD
            ]
            out.append(row[:top_i])
        return out

    def get_caption_embeddings(
        self, top_k: int, batch_filenames: list[list[str]], embed_dim: int | None = None
    ) -> np.ndarray:
        """Walk retrieved images in order, reconstruct their caption vectors
        until ``top_k``; zero-pad (reference ``faiss_store.py:188-251``)."""
        d = embed_dim or self.caption_dim
        out = np.zeros((len(batch_filenames), top_k, d), np.float32)
        for b, filenames in enumerate(batch_filenames):
            k = 0
            for fname in filenames:
                for ci in self.filename_to_caption_indices.get(fname, []):
                    if k >= top_k:
                        break
                    out[b, k] = self.caption_index.reconstruct(ci)
                    k += 1
                if k >= top_k:
                    break
        return out

    # -- persistence ----------------------------------------------------------
    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self.image_index.save(os.path.join(directory, "image.index"))
        self.caption_index.save(os.path.join(directory, "caption.index"))
        meta = {
            "backend": "hnsw" if isinstance(self.image_index, HNSWIndex) else "flat",
            "image_dim": self.image_index.dim,
            "caption_dim": self.caption_dim,
            "image_filenames": self.image_filenames,
            "caption_ids": self.caption_ids.tolist(),
            "filename_to_caption_indices": self.filename_to_caption_indices,
        }
        with open(os.path.join(directory, "store_meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, directory: str) -> "VectorStore":
        with open(os.path.join(directory, "store_meta.json")) as f:
            meta = json.load(f)
        index_cls = HNSWIndex if meta["backend"] == "hnsw" else FlatIPIndex
        image_index = index_cls.load(os.path.join(directory, "image.index"), meta["image_dim"])
        caption_index = index_cls.load(
            os.path.join(directory, "caption.index"), meta["caption_dim"]
        )
        return cls(
            image_index,
            caption_index,
            meta["image_filenames"],
            np.asarray(meta["caption_ids"], np.int64),
            {k: list(v) for k, v in meta["filename_to_caption_indices"].items()},
            meta["caption_dim"],
        )


def create_store(
    image_filenames: Sequence[str],
    image_embeddings: np.ndarray,
    caption_entries: Sequence[dict[str, Any]],
    backend: str = "hnsw",
    M: int = 32,
    ef_construction: int = 200,
    ef_search: int = 64,
) -> VectorStore:
    """Build the dual-index store (reference ``create_faiss_store`` +
    ``run_faiss_indexing_pipeline`` index construction,
    ``faiss_indexing.py:61-141``)."""
    image_embeddings = np.asarray(image_embeddings, np.float32)
    cap_matrix, cap_ids, by_fname = _build_caption_side(image_filenames, caption_entries)

    if backend == "hnsw":
        image_index = HNSWIndex(image_embeddings.shape[1], M, ef_construction, ef_search)
        caption_index = HNSWIndex(cap_matrix.shape[1], M, ef_construction, ef_search)
    elif backend == "flat":
        image_index = FlatIPIndex(image_embeddings.shape[1])
        caption_index = FlatIPIndex(cap_matrix.shape[1])
    else:
        raise ValueError(f"Unknown backend {backend!r} (expected 'hnsw' or 'flat')")
    image_index.add(image_embeddings)
    if len(cap_matrix):
        caption_index.add(cap_matrix)
    return VectorStore(
        image_index, caption_index, list(image_filenames), cap_ids, by_fname,
        cap_matrix.shape[1],
    )


# ---------------------------------------------------------------------------
# Persistent store (ObjectBox-parity)
# ---------------------------------------------------------------------------

class PersistentVectorStore:
    """Disk-backed store: mmap'd embedding matrices + HNSW image index +
    JSON metadata, living in a directory (the reference's ObjectBox database
    directory role).  Reads are mmap'd so many processes can share it."""

    def __init__(self, directory: str):
        self.directory = directory
        with open(os.path.join(directory, "persistent_meta.json")) as f:
            meta = json.load(f)
        self.image_filenames: list[str] = meta["image_filenames"]
        self.filename_to_caption_indices = {
            k: list(v) for k, v in meta["filename_to_caption_indices"].items()
        }
        self.caption_ids = np.asarray(meta["caption_ids"], np.int64)
        self.image_embeddings = np.load(
            os.path.join(directory, "image_embeddings.npy"), mmap_mode="r"
        )
        self.caption_embeddings = np.load(
            os.path.join(directory, "caption_embeddings.npy"), mmap_mode="r"
        )
        # precomputed caption↔image similarity (objectbox_indexing.py:93-114)
        self.caption_image_similarity = np.load(
            os.path.join(directory, "caption_image_similarity.npy"), mmap_mode="r"
        )
        self.image_index = HNSWIndex.load(
            os.path.join(directory, "image.index"), self.image_embeddings.shape[1]
        )

    def retrieve_images_by_vector_similarity(self, query_vectors, top_i: int):
        scores, ids = self.image_index.search(np.asarray(query_vectors, np.float32), top_i + 1)
        out = []
        for row_s, row_i in zip(scores, ids):
            row = [
                (self.image_filenames[int(i)], float(s))
                for s, i in zip(row_s, row_i)
                if i >= 0 and s <= SELF_MATCH_THRESHOLD
            ]
            out.append(row[:top_i])
        return out

    def get_caption_embeddings(self, top_k: int, batch_filenames, embed_dim=None):
        d = self.caption_embeddings.shape[1]
        out = np.zeros((len(batch_filenames), top_k, d), np.float32)
        for b, filenames in enumerate(batch_filenames):
            k = 0
            for fname in filenames:
                for ci in self.filename_to_caption_indices.get(fname, []):
                    if k >= top_k:
                        break
                    out[b, k] = self.caption_embeddings[ci]
                    k += 1
                if k >= top_k:
                    break
        return out

    def retrieve_for_single_embedding(self, embedding: np.ndarray, top_i: int, top_k: int):
        """Per-item helper (the reference threads this through a pool,
        ``objectbox_store.py:126-147``) → (top_k, D)."""
        results = self.retrieve_images_by_vector_similarity(embedding[None], top_i)
        return self.get_caption_embeddings(top_k, [[f for f, _ in results[0]]])[0]


def create_persistent_store(
    directory: str,
    image_filenames: Sequence[str],
    image_embeddings: np.ndarray,
    caption_entries: Sequence[dict[str, Any]],
    M: int = 32,
    ef_construction: int = 200,
    ef_search: int = 64,
) -> PersistentVectorStore:
    """Write a persistent store directory and open it."""
    os.makedirs(directory, exist_ok=True)
    image_embeddings = np.asarray(image_embeddings, np.float32)
    cap_matrix, cap_ids, by_fname = _build_caption_side(image_filenames, caption_entries)

    np.save(os.path.join(directory, "image_embeddings.npy"), image_embeddings)
    np.save(os.path.join(directory, "caption_embeddings.npy"), cap_matrix)

    # precompute per-caption dot product with its own image's embedding
    fname_to_img = {f: i for i, f in enumerate(image_filenames)}
    sims = np.zeros((len(cap_matrix),), np.float32)
    for fname, cap_idx in by_fname.items():
        img = fname_to_img.get(fname)
        if img is None:
            continue
        for ci in cap_idx:
            sims[ci] = float(cap_matrix[ci] @ image_embeddings[img])
    np.save(os.path.join(directory, "caption_image_similarity.npy"), sims)

    index = HNSWIndex(image_embeddings.shape[1], M, ef_construction, ef_search)
    index.add(image_embeddings)
    index.save(os.path.join(directory, "image.index"))

    with open(os.path.join(directory, "persistent_meta.json"), "w") as f:
        json.dump(
            {
                "image_filenames": list(image_filenames),
                "caption_ids": cap_ids.tolist(),
                "filename_to_caption_indices": by_fname,
            },
            f,
        )
    return PersistentVectorStore(directory)
