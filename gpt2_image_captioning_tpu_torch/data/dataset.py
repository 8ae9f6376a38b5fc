"""COCO captions and training batches — the counterpart of
``gpt2_image_captioning_tpu/data/dataset.py`` (``split_coco_annotations``,
``CaptionData``, ``CocoDataset``, ``Batcher``), in plain numpy on the host.

The whole caption set is tokenized once, up front, into dense int32 arrays
(captions + EOS, padded with EOS and truncated to ``max_length``, -100
labels on the padding), so batching is array slicing.  The embeddings come
from a ``.pt`` or ``.npz`` file through :mod:`data.embeddings_io`.  The
batches stay numpy arrays: the train step and the decoders move them to
the card.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer, load_gpt2_tokenizer
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX


def split_coco_annotations(
    annotations_path: str, output_dir: str, split_ratio: float = 0.8, seed: int = 42
) -> None:
    """Split a COCO annotations JSON into train/val **by image id** (an image
    and all its captions stay together; the ids are shuffled by
    ``random.seed(seed)``, as the JAX package does).  Writes
    ``train_split.json`` / ``val_split.json`` in COCO format."""
    with open(annotations_path, "r") as f:
        coco = json.load(f)

    images = coco["images"]
    annotations = coco["annotations"]
    ids = [img["id"] for img in images]
    random.seed(seed)
    random.shuffle(ids)
    cutoff = int(len(ids) * split_ratio)
    train_ids, val_ids = set(ids[:cutoff]), set(ids[cutoff:])
    print(f"Splitting: {len(train_ids)} Train images, {len(val_ids)} Val images.")

    common = {"info": coco.get("info", {}), "licenses": coco.get("licenses", [])}
    os.makedirs(output_dir, exist_ok=True)
    for name, keep in (("train_split.json", train_ids), ("val_split.json", val_ids)):
        subset = {
            **common,
            "images": [im for im in images if im["id"] in keep],
            "annotations": [a for a in annotations if a["image_id"] in keep],
        }
        with open(os.path.join(output_dir, name), "w") as f:
            json.dump(subset, f)
    print(f"Created:\n- {output_dir}/train_split.json\n- {output_dir}/val_split.json")


@dataclass
class CaptionData:
    """One caption entry (multiple captions can share an image)."""

    image_id: int
    embedding_index: int
    caption_text: str


class CocoDataset:
    """Caption-level dataset over precomputed image embeddings: an
    embeddings file, a COCO annotations JSON and a tokenizer with pad = eos
    (the GPT-2 assets by default), materialized into dense arrays at
    construction.  Every annotated image id must have an embedding."""

    def __init__(
        self,
        embeddings_path: str,
        annotations_path: str,
        tokenizer: GPT2BPETokenizer | None = None,
        max_length: int = 50,
        normalize_embeddings: bool = False,
    ):
        self.tokenizer = tokenizer or load_gpt2_tokenizer()
        self.max_length = max_length
        self.normalize_embeddings = normalize_embeddings

        self.image_filenames, emb = load_embeddings(embeddings_path)
        if normalize_embeddings:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        self.image_embeddings: np.ndarray = emb

        self.image_id_to_index: dict[int, int] = {
            self.get_image_id_from_filename(f): i for i, f in enumerate(self.image_filenames)
        }

        with open(annotations_path, "r") as f:
            coco = json.load(f)
        missing = {
            a["image_id"] for a in coco["annotations"]
            if a["image_id"] not in self.image_id_to_index
        }
        if missing:
            sample = sorted(missing)[:5]
            raise KeyError(
                f"{len(missing)} annotation image ids have no embedding in "
                f"{embeddings_path} (e.g. {sample}) — did you extract embeddings "
                "for this split's image directory?"
            )
        self.captions: list[CaptionData] = [
            CaptionData(
                image_id=a["image_id"],
                embedding_index=self.image_id_to_index[a["image_id"]],
                caption_text=a["caption"],
            )
            for a in coco["annotations"]
        ]
        print(
            f"Dataset ready: {len(self.image_filenames)} images, {len(self.captions)} captions."
        )
        self._materialize()

    @staticmethod
    def get_image_id_from_filename(filename: str) -> int:
        """'COCO_train2014_000000123456.jpg' → 123456 (also plain
        '000000123456.jpg')."""
        return int(filename.split("_")[-1].split(".")[0])

    def _materialize(self) -> None:
        """Tokenize every caption once into dense (N, L) arrays."""
        texts = [c.caption_text + self.tokenizer.eos_token for c in self.captions]
        enc = self.tokenizer(
            texts, max_length=self.max_length, padding="max_length", truncation=True
        )
        self.token_ids: np.ndarray = enc["input_ids"].astype(np.int32)
        self.attention_mask: np.ndarray = enc["attention_mask"].astype(np.int32)
        labels = self.token_ids.copy()
        labels[self.attention_mask == 0] = IGNORE_INDEX
        self.labels: np.ndarray = labels
        self.embedding_indices: np.ndarray = np.array(
            [c.embedding_index for c in self.captions], dtype=np.int32
        )
        self.image_ids: np.ndarray = np.array(
            [c.image_id for c in self.captions], dtype=np.int64
        )

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, idx: int) -> dict:
        c = self.captions[idx]
        return {
            "token_ids": self.token_ids[idx],
            "labels": self.labels[idx],
            "image_embedding": self.image_embeddings[c.embedding_index],
            "attention_mask": self.attention_mask[idx],
            "caption_text": c.caption_text,
            "image_id": c.image_id,
        }

    def gather_batch(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {
            "token_ids": self.token_ids[idx],
            "labels": self.labels[idx],
            "attention_mask": self.attention_mask[idx],
            "image_embedding": self.image_embeddings[self.embedding_indices[idx]],
            "image_id": self.image_ids[idx],
        }

    def unique_image_batches(self, batch_size: int) -> Iterator[dict[str, np.ndarray]]:
        """Batches over *unique images* in first-seen order, for generation
        and evaluation (one caption per image).  The final batch is padded
        to full size by repeating its last image, with ``valid`` marking the
        real rows."""
        seen: set[int] = set()
        order: list[int] = []
        for i, c in enumerate(self.captions):
            if c.image_id not in seen:
                seen.add(c.image_id)
                order.append(i)
        idx = np.array(order, dtype=np.int64)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start : start + batch_size]
            valid = np.ones(batch_size, dtype=bool)
            if len(chunk) < batch_size:
                valid[len(chunk) :] = False
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_size - len(chunk))])
            yield {
                "image_embedding": self.image_embeddings[self.embedding_indices[chunk]],
                "image_id": self.image_ids[chunk],
                "valid": valid,
            }


class Batcher:
    """Shuffled fixed-shape training batches with pad-and-mask semantics.

    Every epoch covers all captions exactly once; the permutation is a pure
    function of (seed, epoch), so a resumed run replays the same order and
    every process agrees on it.  The final partial batch is padded to
    ``batch_size`` by repeating its last index, and the padded rows get -100
    labels, so they add nothing to the loss.  ``dataset`` is a
    :class:`CocoDataset`, or anything with ``__len__`` and
    ``gather_batch(indices) → dict of arrays``.

    ``batch_size`` is global.  With ``process_index`` / ``process_count``
    (a data-parallel rank and the number of ranks) each process yields only
    its contiguous shard of every batch, and the padded rows are labelled
    -100 on whichever process holds them.
    """

    def __init__(self, dataset: CocoDataset, batch_size: int, seed: int = 0,
                 process_index: int | None = None, process_count: int | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index or 0
        self.process_count = process_count or 1
        if batch_size % self.process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by process_count {self.process_count}"
            )
        self._next_epoch = 0

    @property
    def steps_per_epoch(self) -> int:
        return -(-len(self.ds) // self.batch_size)

    def epoch(self, epoch_idx: int | None = None) -> Iterator[dict[str, np.ndarray]]:
        if epoch_idx is None:
            epoch_idx = self._next_epoch
            self._next_epoch += 1
        perm = np.random.default_rng([self.seed, epoch_idx]).permutation(len(self.ds))
        bs = self.batch_size
        shard = bs // self.process_count
        lo = self.process_index * shard
        for start in range(0, len(perm), bs):
            idx = perm[start : start + bs]
            n_real = len(idx)
            if n_real < bs:
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - n_real)])
            batch = self.ds.gather_batch(idx[lo : lo + shard])
            pad_start = max(0, n_real - lo)
            if pad_start < shard:
                batch["labels"] = batch["labels"].copy()
                batch["labels"][pad_start:] = IGNORE_INDEX
            yield batch
