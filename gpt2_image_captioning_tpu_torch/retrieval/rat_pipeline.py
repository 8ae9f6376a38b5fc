"""The RAT training pipeline: config → vector store → retrieval-augmented
training — the counterpart of ``gpt2_image_captioning_tpu/retrieval/rat_pipeline.py``,
the path ``training_pipeline.run`` takes when ``retrieval_augmentation:
true``: build a store from the extracted image and caption embeddings, wrap
the captioner with the aggregator, and run :func:`train.loop.train_rat`.
The store's backend comes from ``retrieval.backend``:

- ``device`` (default): exact retrieval on the card, inside the train step;
- ``hnsw`` / ``flat``: the C++ index through the host API, prefetched a
  batch ahead of the step;
- ``persistent``: the memory-mapped store under ``paths.vector_db_path``.
"""

from __future__ import annotations

import os

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE
from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
from gpt2_image_captioning_tpu_torch.models.rat import RATConfig


def load_caption_entries(path: str):
    """The grouped caption-embeddings artifact (a ``.pt`` list)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def caption_embeddings_file(cfg) -> str:
    """``{embeddings_path}/train_{vision_encoder}_caption_embeddings.pt``."""
    return os.path.join(cfg.paths.embeddings_path,
                        f"train_{cfg.vision_encoder}_caption_embeddings.pt")


def build_store(cfg, backend: str | None = None, device=DEFAULT_DEVICE):
    """``config.yml``'s paths → a store of ``backend`` (default
    ``retrieval.backend``, else ``device``); the device store lives on
    ``device``."""
    from gpt2_image_captioning_tpu_torch.training_pipeline import embeddings_file

    backend = backend or cfg.retrieval.get("backend", "device")
    filenames, image_emb = load_embeddings(embeddings_file(cfg, "train"))
    caption_entries = load_caption_entries(caption_embeddings_file(cfg))
    if backend == "device":
        from gpt2_image_captioning_tpu_torch.retrieval.exact import DeviceVectorStore

        return DeviceVectorStore.build(filenames, image_emb, caption_entries, device=device)
    if backend in ("hnsw", "flat"):
        from gpt2_image_captioning_tpu_torch.retrieval.store import create_store

        return create_store(filenames, image_emb, caption_entries, backend=backend)
    if backend == "persistent":
        from gpt2_image_captioning_tpu_torch.retrieval.store import create_persistent_store

        return create_persistent_store(cfg.paths.vector_db_path, filenames, image_emb,
                                       caption_entries)
    raise ValueError(f"Unknown retrieval backend: {backend!r}")


def rat_config(cfg) -> RATConfig:
    """``config.yml``'s ``retrieval`` block → :class:`RATConfig`."""
    return RATConfig(
        embed_dim=cfg.retrieval.embed_dim,
        aggregation_type=cfg.retrieval.get("aggregation_type", "mean"),
        top_k=cfg.retrieval.top_k,
        top_i=cfg.retrieval.top_i,
    )


def wrap_model(cfg, model):
    """The captioner façade upgraded in place of a copy to the RAT wrapper:
    its trees kept, an aggregator seeded by ``seed + 1`` added."""
    from gpt2_image_captioning_tpu_torch.models.rat import RetrievalAugmentedTransformer

    return RetrievalAugmentedTransformer.wrap(model, rat_config(cfg), cfg.get("seed", 42) + 1)


def run_rat_training(cfg, model, train_ds, val_ds, save_dir: str, device=DEFAULT_DEVICE,
                     **train_kw) -> dict:
    """Called by ``training_pipeline.run`` for ``retrieval_augmentation``
    configs; ``train_kw`` passes the ``tpu`` block's options to ``train()``."""
    from gpt2_image_captioning_tpu_torch.train.loop import train_rat

    rat_model = wrap_model(cfg, model)
    rcfg = rat_model.rcfg
    return train_rat(
        train_ds,
        rat_model,
        build_store(cfg, device=device),
        top_k=rcfg.top_k,
        top_i=rcfg.top_i,
        batch_size=cfg.training.batch_size,
        num_epochs=cfg.training.num_epochs,
        learning_rate=cfg.training.learning_rate,
        num_warmup_steps=cfg.training.num_warmup_steps,
        save_every_epoch=cfg.training.save_every_epoch,
        outputs_dir=save_dir,
        val_dataset=val_ds,
        val_annotations_path=os.path.join(cfg.paths.annotations_path, "captions_val2017.json"),
        eval_every_epoch=cfg.validation.eval_every_epoch,
        eval_batch_size=cfg.validation.batch_size,
        eval_max_length=cfg.max_caption_length,
        eval_temperature=cfg.validation.temperature,
        eval_top_p=cfg.validation.top_p,
        seed=cfg.get("seed", 42),
        device=device,
        **train_kw,
    )
