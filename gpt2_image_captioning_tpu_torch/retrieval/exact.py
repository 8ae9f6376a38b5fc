"""Exact retrieval on the device — the counterpart of
``gpt2_image_captioning_tpu/retrieval/exact.py``.

The corpus lives in device memory (COCO train2017: 118,287 × 512 image
vectors and 591,753 × 512 caption vectors in float32, about 1.45 GB), so a
RAT step retrieves inside the step: one float32 product of the queries by
every image vector, the top ``top_i`` images, then their captions gathered
through a padded image → caption-index table.  The semantics are the JAX
package's, which are the reference stores':

- a similarity above 0.9999 is the query's own image (or an exact copy of
  it) and is dropped;
- images are ranked by similarity, lower index first among equals, as
  ``jax.lax.top_k`` ranks them (``torch.topk`` promises no order there, so
  the ties are ordered here explicitly);
- captions are taken walking the ranked images in order, each image's in
  the table's order, up to ``top_k``: a stable sort on invalidity packs the
  valid ones first and the ``-1`` padding last; packed rows past the
  available captions are zeros.  When ``top_i`` images hold fewer than
  ``top_k`` table slots in all, the result has those slots' rows only, as
  the JAX function's ``order[:, :top_k]`` does.

The similarity product is float32 without TF32: TF32 moves similarities
across 0.9999 and reorders near-ties.  It is ``torch.matmul`` and a
selection in torch, as the JAX package's is an XLA product and
``lax.top_k`` outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import Any, Sequence

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

SELF_MATCH_THRESHOLD = 0.9999


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def similarities(queries: torch.Tensor, image_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, N) float32 inner products, the query's own image (> 0.9999) at -inf."""
    with _no_tf32():
        sims = torch.matmul(queries.float(), image_embeddings.t())
    return sims.masked_fill(sims > SELF_MATCH_THRESHOLD, float("-inf"))


def top_images(sims: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row in ``jax.lax.top_k``'s order: value
    descending, the lower index first among equal values, at the top-k
    boundary too → (values (B, k), indices (B, k) int64).

    One ``topk`` over distinct int64 keys: a float32's bits mapped onto an
    order-preserving int32 (a negative value's magnitude bits flipped: the
    total order XLA's ``top_k`` sorts by, -0 below +0) in the high half,
    ``n - 1 - index`` in the low half."""
    n = sims.shape[-1]
    bits = sims.view(torch.int32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = bits * 2 ** 32 + (n - 1 - torch.arange(n, device=sims.device))
    idx = torch.topk(key, k, dim=-1).indices
    return sims.gather(-1, idx), idx


def gather_captions(img_idx: torch.Tensor, caption_embeddings: torch.Tensor,
                    caption_table: torch.Tensor, top_k: int) -> torch.Tensor:
    """(B, I) ranked image indices → (B, min(top_k, I·C_max), Dc) caption
    embeddings: the images' table rows walked in order, valid entries packed
    first by a stable sort, padding rows zero."""
    b = img_idx.shape[0]
    flat = caption_table[img_idx].reshape(b, -1)
    valid = flat >= 0
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices[:, :top_k]
    packed = flat.gather(-1, order)
    packed_valid = valid.gather(-1, order)
    emb = caption_embeddings[packed.clamp(min=0)]
    return torch.where(packed_valid[..., None], emb, 0.0)


def fused_retrieve(queries: torch.Tensor, image_embeddings: torch.Tensor,
                   caption_embeddings: torch.Tensor, caption_table: torch.Tensor, *,
                   top_i: int, top_k: int) -> torch.Tensor:
    """Exact top-i image search and the ordered caption gather, on the
    store's device: (B, D) queries → (B, top_k, Dc) caption embeddings."""
    _, img_idx = top_images(similarities(queries, image_embeddings), top_i)
    return gather_captions(img_idx, caption_embeddings, caption_table, top_k)


class DeviceVectorStore:
    """Image and caption embedding matrices on the device, plus the padded
    caption-index table that makes the caption gather one indexing op."""

    def __init__(
        self,
        image_filenames: list[str],
        image_embeddings,  # (N, D) L2-normalised
        caption_embeddings,  # (M, Dc)
        caption_ids,  # (M,)
        image_caption_table,  # (N, C_max) indices into the captions, -1 pad
        device=DEFAULT_DEVICE,
    ):
        device = resolve_device(device)
        self.device = device
        self.image_filenames = list(image_filenames)
        self.filename_to_index = {f: i for i, f in enumerate(self.image_filenames)}
        self.image_embeddings = torch.as_tensor(image_embeddings, dtype=torch.float32,
                                                device=device)
        self.caption_embeddings = torch.as_tensor(caption_embeddings, dtype=torch.float32,
                                                  device=device)
        self.caption_ids = np.asarray(caption_ids)
        self.caption_table = torch.as_tensor(image_caption_table, dtype=torch.int64,
                                             device=device)

    @classmethod
    def build(cls, image_filenames: Sequence[str], image_embeddings,
              caption_entries: Sequence[dict[str, Any]],
              device=DEFAULT_DEVICE) -> "DeviceVectorStore":
        """``caption_entries``: the grouped word-embeddings artifact,
        ``[{"filenames": fname, "embeddings": [{"caption_id", "embedding"}]}]``
        (:mod:`embeddings.word_embeddings`); entries of images not in
        ``image_filenames`` are skipped."""
        fname_to_img = {f: i for i, f in enumerate(image_filenames)}
        cap_vecs: list[np.ndarray] = []
        cap_ids: list[int] = []
        per_image: list[list[int]] = [[] for _ in image_filenames]
        for item in caption_entries:
            img = fname_to_img.get(item["filenames"])
            if img is None:
                continue
            for e in item["embeddings"]:
                vec = e["embedding"]
                if isinstance(vec, torch.Tensor):
                    vec = vec.float().numpy()
                per_image[img].append(len(cap_vecs))
                cap_vecs.append(np.asarray(vec, np.float32))
                cap_ids.append(int(e["caption_id"]))
        c_max = max((len(v) for v in per_image), default=1) or 1
        table = np.full((len(image_filenames), c_max), -1, np.int64)
        for img, idxs in enumerate(per_image):
            table[img, : len(idxs)] = idxs
        image_embeddings = np.asarray(image_embeddings, np.float32)
        cap_matrix = (np.stack(cap_vecs) if cap_vecs
                      else np.zeros((1, image_embeddings.shape[1]), np.float32))
        return cls(list(image_filenames), image_embeddings, cap_matrix,
                   np.asarray(cap_ids, np.int64), table, device=device)

    def arrays(self) -> dict[str, torch.Tensor]:
        """The side input of the fused train step (:func:`models.rat.loss_fn_fused`)."""
        return {"image_embeddings": self.image_embeddings,
                "caption_embeddings": self.caption_embeddings,
                "caption_table": self.caption_table}

    def retrieve_fused(self, queries, top_i: int, top_k: int) -> torch.Tensor:
        """(B, D) queries → (B, top_k, Dc) caption embeddings on the store's device."""
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        return fused_retrieve(queries, self.image_embeddings, self.caption_embeddings,
                              self.caption_table, top_i=top_i, top_k=top_k)

    def search_images(self, query_vectors, top_i: int) -> tuple[np.ndarray, np.ndarray]:
        """(similarities (B, top_i), image indices (B, top_i)) as numpy; a
        dropped self-match reads -inf."""
        queries = torch.as_tensor(query_vectors, dtype=torch.float32, device=self.device)
        sims, idx = top_images(similarities(queries, self.image_embeddings), top_i)
        return sims.cpu().numpy(), idx.cpu().numpy()


# ---------------------------------------------------------------------------
# Host-facing module API (the reference stores' functions)
# ---------------------------------------------------------------------------

def retrieve_images_by_vector_similarity(
    store: DeviceVectorStore, query_vectors, top_i: int
) -> list[list[tuple[str, float]]]:
    """Batched image search → per query ``[(filename, score), ...]``."""
    sims, idx = store.search_images(query_vectors, top_i)
    return [[(store.image_filenames[int(i)], float(s)) for s, i in zip(row_s, row_i)
             if np.isfinite(s)] for row_s, row_i in zip(sims, idx)]


def get_caption_embeddings(
    store: DeviceVectorStore,
    top_k: int,
    batch_filenames: list[list[str]],
    embed_dim: int = 512,
) -> np.ndarray:
    """The captions of each query's retrieved images, in order, zero-padded
    to ``top_k`` → (B, top_k, Dc) float32."""
    out = np.zeros((len(batch_filenames), top_k, store.caption_embeddings.shape[1]), np.float32)
    cap_matrix = store.caption_embeddings.cpu().numpy()
    table = store.caption_table.cpu().numpy()
    for b, filenames in enumerate(batch_filenames):
        k = 0
        for fname in filenames:
            img = store.filename_to_index.get(fname)
            if img is None:
                continue
            for cap_idx in table[img]:
                if cap_idx < 0 or k >= top_k:
                    break
                out[b, k] = cap_matrix[cap_idx]
                k += 1
            if k >= top_k:
                break
    return out
