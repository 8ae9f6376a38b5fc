"""Retrieval-augmented training (RAT): the aggregator and the augmented
captioner — the counterpart of ``gpt2_image_captioning_tpu/models/rat.py``.

The top-k retrieved caption embeddings of an image are pooled (``mean``,
``max``, ``sum_norm`` or a learned ``attention`` over the k) and added to
the image embedding, and the standard captioner runs on the sum.  With a
:class:`retrieval.exact.DeviceVectorStore` the retrieval runs inside the
train step (:func:`loss_fn_fused`), so a RAT step never leaves the card;
with a host store (the C++ HNSW, flat or persistent stores) the batch
carries its retrieved embeddings (:func:`loss_fn`), fetched by
:func:`augment_batch`'s API a batch ahead.

The aggregator's trees: ``{}`` for the parameter-free kinds,
``{"attention_proj": {"w": (embed_dim, 1), "b": (1,)}}`` for ``attention``,
kept under ``trainable["aggregator"]``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves, tree_map
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.ops import nn

AGGREGATION_TYPES = ("mean", "max", "sum_norm", "attention")


@dataclasses.dataclass(frozen=True)
class RATConfig:
    embed_dim: int = 512
    aggregation_type: str = "mean"
    top_k: int = 10
    top_i: int = 4


def init_aggregator(generator: torch.Generator, cfg: RATConfig, device=DEFAULT_DEVICE) -> dict:
    """Only ``attention`` has parameters: Linear(embed_dim → 1) at torch's
    default init, float32 on ``device``."""
    if cfg.aggregation_type == "attention":
        proj = nn.dense_init(generator, cfg.embed_dim, 1, std=None)
        return {"attention_proj": tree_map(lambda t: t.to(resolve_device(device)), proj)}
    return {}


def aggregate(params: dict, cfg: RATConfig, query_embedding: torch.Tensor,
              retrieved_embeddings: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    """Pool the retrieved (B, K, D) embeddings in float32 and add them to the
    (B, D) queries; the result takes the queries' dtype."""
    kind = cfg.aggregation_type
    r = retrieved_embeddings.float()
    if kind == "mean":
        agg = r.mean(dim=1)
    elif kind == "max":
        agg = r.amax(dim=1)
    elif kind == "sum_norm":
        normalized = r / torch.linalg.vector_norm(r, dim=2, keepdim=True).clamp(min=1e-12)
        summed = normalized.sum(dim=1)
        agg = summed / torch.linalg.vector_norm(summed, dim=1, keepdim=True).clamp(min=1e-12)
    elif kind == "attention":
        scores = nn.dense(params["attention_proj"], r, policy).float()  # (B, K, 1)
        agg = (r * torch.softmax(scores, dim=1)).sum(dim=1)
    else:
        raise ValueError(f"Unknown aggregation_type: {kind}")
    return (query_embedding.float() + agg).to(query_embedding.dtype)


def _augmented(trainable, rcfg, image_embeddings, retrieved, policy):
    return aggregate(trainable.get("aggregator", {}), rcfg, image_embeddings, retrieved, policy)


def loss_fn(trainable: dict, frozen: dict, ccfg: C.CaptionerConfig, rcfg: RATConfig,
            batch: dict, policy: Policy = F32,
            use_kernels: bool | None = None, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-store path: ``batch["retrieved_embeddings"]`` (B, K, D) given →
    (nll_sum, token_count) of :func:`models.captioner.loss_fn` on the
    augmented embeddings (``mesh`` as there)."""
    aug = _augmented(trainable, rcfg, batch["image_embedding"], batch["retrieved_embeddings"],
                     policy)
    return C.loss_fn(trainable, frozen, ccfg, dict(batch, image_embedding=aug), policy,
                     use_kernels, mesh)


def loss_fn_fused(trainable: dict, frozen: dict, ccfg: C.CaptionerConfig, rcfg: RATConfig,
                  batch: dict, store_arrays: dict, policy: Policy = F32,
                  use_kernels: bool | None = None, mesh=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused path: the exact retrieval inside the step.  ``store_arrays``:
    ``DeviceVectorStore.arrays()`` (image embeddings, caption embeddings,
    caption table), on the batch's device."""
    from gpt2_image_captioning_tpu_torch.retrieval.exact import fused_retrieve

    retrieved = fused_retrieve(
        batch["image_embedding"].float(), store_arrays["image_embeddings"],
        store_arrays["caption_embeddings"], store_arrays["caption_table"],
        top_i=rcfg.top_i, top_k=rcfg.top_k)
    aug = _augmented(trainable, rcfg, batch["image_embedding"], retrieved, policy)
    return C.loss_fn(trainable, frozen, ccfg, dict(batch, image_embedding=aug), policy,
                     use_kernels, mesh)


def partition_specs(ccfg: C.CaptionerConfig, rcfg: RATConfig) -> tuple[dict, dict]:
    """:func:`models.captioner.partition_specs` with the attention
    aggregator's projection, which stays replicated over tp (the JAX
    ``rat.py:96-101``)."""
    trainable, frozen = C.partition_specs(ccfg)
    if rcfg.aggregation_type == "attention":
        trainable["aggregator"] = None
    return trainable, frozen


def retrieve(rcfg: RATConfig, db_store, image_embeddings) -> np.ndarray | torch.Tensor:
    """The (B, top_k, Dc) caption embeddings of a store for (B, D) queries:
    the device store's fused retrieval, or any host store's API
    (``retrieve_images_by_vector_similarity`` + ``get_caption_embeddings``)."""
    from gpt2_image_captioning_tpu_torch.retrieval.exact import DeviceVectorStore

    if isinstance(db_store, DeviceVectorStore):
        return db_store.retrieve_fused(image_embeddings, rcfg.top_i, rcfg.top_k)
    if isinstance(image_embeddings, torch.Tensor):
        image_embeddings = image_embeddings.detach().cpu().numpy()
    results = db_store.retrieve_images_by_vector_similarity(
        np.asarray(image_embeddings, np.float32), rcfg.top_i)
    return db_store.get_caption_embeddings(rcfg.top_k, [[f for f, _ in row] for row in results])


def augment_batch(trainable: dict, rcfg: RATConfig, db_store, image_embeddings,
                  policy: Policy = F32) -> torch.Tensor:
    """Retrieve for (B, D) embeddings (an array or a tensor) from any store
    and aggregate → the augmented (B, D) float32 embeddings on the trees'
    device."""
    device = tree_leaves(trainable)[0].device
    emb = torch.as_tensor(np.asarray(image_embeddings, np.float32)
                          if not isinstance(image_embeddings, torch.Tensor) else image_embeddings,
                          dtype=torch.float32, device=device)
    retrieved = torch.as_tensor(retrieve(rcfg, db_store, emb), dtype=torch.float32,
                                device=device)
    return _augmented(trainable, rcfg, emb, retrieved, policy)


class RetrievalAugmentedTransformer(C.ImageCaptioningModel):
    """The captioner façade with an aggregator: ``rcfg`` gives the pooling and
    the default retrieval depths; ``generate(db_store=...)`` decodes from
    the augmented embeddings.  ``generator`` seeds the captioner's init and,
    after it, the aggregator's."""

    def __init__(self, rcfg: RATConfig, cfg: C.CaptionerConfig, tokenizer=None,
                 generator: torch.Generator | None = None, **kwargs):
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        super().__init__(cfg, tokenizer, generator, **kwargs)
        self.rcfg = rcfg
        agg = init_aggregator(generator, rcfg, self.device)
        if agg:
            self.trainable["aggregator"] = agg

    @classmethod
    def wrap(cls, model: C.ImageCaptioningModel, rcfg: RATConfig,
             seed: int) -> "RetrievalAugmentedTransformer":
        """``model`` upgraded to the RAT wrapper (the same trees, not copies)
        with a fresh aggregator drawn from ``seed``."""
        rat = cls.__new__(cls)
        rat.__dict__.update(model.__dict__)
        rat.rcfg = rcfg
        agg = init_aggregator(torch.Generator().manual_seed(seed), rcfg, rat.device)
        if agg:
            rat.trainable["aggregator"] = agg
        return rat

    def augment(self, image_embeddings, db_store, top_k: int | None = None,
                top_i: int | None = None) -> torch.Tensor:
        """The augmented embeddings at the model's own precision and trees."""
        rcfg = dataclasses.replace(self.rcfg, top_k=top_k or self.rcfg.top_k,
                                   top_i=top_i or self.rcfg.top_i)
        return augment_batch(self.trainable, rcfg, db_store, image_embeddings, self.policy)

    def generate(self, image_embeddings, db_store=None, top_k: int | None = None,
                 top_i: int | None = None, **kw) -> torch.Tensor:
        """:meth:`ImageCaptioningModel.generate` of the embeddings augmented
        from ``db_store`` (at ``top_k`` / ``top_i``, default ``rcfg``'s); as
        the plain façade without a store."""
        if db_store is not None:
            image_embeddings = self.augment(image_embeddings, db_store, top_k, top_i)
        return super().generate(image_embeddings, **kw)
