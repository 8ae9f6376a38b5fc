"""Batched caption generation and the evaluation driver — the counterpart of
``gpt2_image_captioning_tpu/evaluation/generation.py``
(``generate_predictions``, ``generate_and_evaluate``, ``evaluate_epoch``,
``generate_test_caption_predictions``).

Batches run over the dataset's unique images (one caption per image), each
the same size, the last padded and its padded rows dropped by ``valid``.
``decode="sample"`` is the reference's dispatch — greedy at ``temperature ==
0``, top-p sampling otherwise — and ``decode="beam"`` beam search; both run
the façade's trees and its cached step-kernel pack at ``decode_precision``
(None/"f32", "bf16" or "int8"), prepared once per evaluation pass, not once
a batch.  A one-deep pipeline dispatches batch i, then BPE-decodes batch i-1
on the host.  The decoders run the CUDA kernels on the card and their plain
twins on the CPU.

Where the port differs from the JAX package:

- The JAX function warns and decodes in bf16 when ``decode_precision="int8"``
  finds its fused kernel not engaged — on the CPU always.  The port has no
  such fallback: int8 runs the port's int8 kernels on the card and their
  plain twins on the CPU, so int8 means int8 everywhere.
- ``rng=`` becomes ``seed=``: sampled batch i draws from a ``torch.Generator``
  on the model's device seeded from (seed, i) — the counterpart of
  ``jax.random.fold_in(rng, i)``; the draws differ from ``jax.random``'s.
- ``mesh`` (a :class:`core.mesh.Mesh`, the same call on every rank): each
  batch is decoded on each dp index's rows and gathered (``generate``'s dp
  path; with ``tp`` > 1 each tp group decodes its rows on the rank's slices
  of the façade's trees, ``ImageCaptioningModel.decode_pack``), so every
  rank holds the predictions in global order, without the padding rows, and
  computes the same metrics from them; rank 0 alone writes the evaluation
  files.

With ``db_store`` (a RAT model, :class:`models.rat.RetrievalAugmentedTransformer`)
each batch's embeddings are retrieval-augmented first — the store's
retrieval and the aggregator at the model's own precision and trees, at
``top_k`` / ``top_i`` (default the model's ``rcfg``) — and then decoded at
``decode_precision``, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.mesh import barrier, tp_active
from gpt2_image_captioning_tpu_torch.evaluation.evaluate import (
    EvalMetrics,
    evaluate_captions,
    save_epoch_artifacts,
)
from gpt2_image_captioning_tpu_torch.models import captioner as C


def check_model_device(model, device) -> torch.device:
    """``device`` resolved (the card unless the caller asks for the CPU;
    raises without one), and the model's parameters held on it."""
    device = resolve_device(device)
    if _indexed(model.device) != _indexed(device):
        raise ValueError(f"the model's parameters are on {model.device}, but device={device}; "
                         "build the model on the device it runs on")
    return device


def _indexed(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def batch_seed(seed: int, i: int) -> int:
    """The seed of batch ``i``'s generator: a pure function of (seed, i)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0] >> 1)


def generate_predictions(
    model,
    dataset,
    *,
    batch_size: int = 32,
    max_length: int = 50,
    temperature: float = 0.0,
    top_p: float = 0.9,
    decode: str = "sample",
    beam_size: int = 4,
    seed: int = 0,
    verbose: bool = True,
    db_store=None,
    top_k: int | None = None,
    top_i: int | None = None,
    mesh=None,
    decode_precision: str | None = None,
    device=DEFAULT_DEVICE,
) -> list[dict[str, Any]]:
    """Generate one caption per unique image → ``[{"image_id", "caption"}]``
    in the dataset's first-seen order.

    ``decode="sample"``: greedy at ``temperature == 0``, else top-p sampling
    at ``temperature`` / ``top_p`` (module-level ``generate``); ``"beam"``:
    ``beam_generate`` with ``beam_size`` beams.  ``decode_precision``: None
    or "f32" (the model's own trees), "bf16" (its cached bfloat16 copy) or
    "int8" (the W8A8 pack of that copy).  ``db_store``: a store to augment
    each batch's embeddings from (the model must be a RAT model), at
    ``top_k`` / ``top_i``.  ``device`` must be where the model lives: the
    card unless the caller asks for the CPU, the mesh's device with a
    ``mesh`` (module docstring)."""
    tp_active(mesh)  # a tp axis must come with its group
    if mesh is not None:
        device = mesh.device
    if decode not in ("sample", "beam"):
        raise ValueError(f"decode must be 'sample' or 'beam', got {decode!r}")
    if db_store is not None and not hasattr(model, "augment"):
        raise TypeError("db_store needs a retrieval-augmented model "
                        "(models.rat.RetrievalAugmentedTransformer)")
    device = check_model_device(model, device)
    tokenizer = dataset.tokenizer
    tr, fz, pol, packed, quant = model.decode_pack(decode_precision, mesh)
    predictions: list[dict[str, Any]] = []
    n_batches = 0
    t0 = time.perf_counter()

    def dispatch(i, batch):
        emb = torch.as_tensor(batch["image_embedding"], dtype=torch.float32, device=device)
        if db_store is not None:
            emb = model.augment(emb, db_store, top_k, top_i)
        if decode == "beam":
            return C.beam_generate(tr, fz, model.cfg, emb, max_length=max_length,
                                   beam_size=beam_size, policy=pol, packed=packed,
                                   decode_quant=quant, mesh=mesh)
        generator = None
        if temperature != 0.0:
            generator = torch.Generator(device=device).manual_seed(batch_seed(seed, i))
        return C.generate(tr, fz, model.cfg, emb, max_length=max_length,
                          temperature=temperature, top_p=top_p, generator=generator,
                          policy=pol, packed=packed, decode_quant=quant, mesh=mesh)

    def consume(batch, ids):
        captions = tokenizer.batch_decode(ids.cpu().numpy(), skip_special_tokens=True)
        for img_id, caption, valid in zip(batch["image_id"], captions, batch["valid"]):
            if valid:
                predictions.append({"image_id": int(img_id), "caption": caption})

    # one-deep pipeline: while the device decodes batch i, the host
    # BPE-decodes and collects batch i-1 (its .cpu() is the sync point)
    pending = None
    for i, batch in enumerate(dataset.unique_image_batches(batch_size)):
        ids = dispatch(i, batch)
        if pending is not None:
            consume(*pending)
        pending = (batch, ids)
        n_batches += 1
    if pending is not None:
        consume(*pending)
    if verbose:
        dt = time.perf_counter() - t0
        eff = "int8" if quant else (decode_precision or "model")
        print(
            f"Generated {len(predictions)} captions in {dt:.1f}s "
            f"({len(predictions) / max(dt, 1e-9):.1f} img/s, {n_batches} batches, "
            f"precision={eff})"
        )
    return predictions


def generate_and_evaluate(
    model,
    dataset,
    annotations_path: str,
    batch_size: int = 32,
    max_length: int = 50,
    temperature: float = 1.0,
    top_p: float = 0.9,
    decode: str = "sample",
    beam_size: int = 4,
    seed: int = 0,
    db_store=None,
    top_k: int | None = None,
    top_i: int | None = None,
    mesh=None,
    decode_precision: str | None = None,
    device=DEFAULT_DEVICE,
    **_ignored,
) -> tuple[list[dict[str, Any]], EvalMetrics]:
    """Generate for the whole dataset, then score against the annotations."""
    predictions = generate_predictions(
        model,
        dataset,
        batch_size=batch_size,
        max_length=max_length,
        temperature=temperature,
        top_p=top_p,
        decode=decode,
        beam_size=beam_size,
        seed=seed,
        db_store=db_store,
        top_k=top_k,
        top_i=top_i,
        mesh=mesh,
        decode_precision=decode_precision,
        device=device,
    )
    metrics = evaluate_captions(predictions, annotations_path)
    return predictions, metrics


def evaluate_epoch(
    model,
    dataset,
    annotations_path: str,
    epoch: int,
    split_name: str,
    batch_size: int = 32,
    max_length: int = 50,
    temperature: float = 1.0,
    top_p: float = 0.9,
    output_dir: str = "eval_results",
    decode: str = "sample",
    beam_size: int = 4,
    rat: bool = False,
    db_store=None,
    top_k: int | None = None,
    top_i: int | None = None,
    mesh=None,
    decode_precision: str | None = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
    **_ignored,
) -> EvalMetrics:
    """Per-epoch evaluation with the reference's artifacts
    (``epoch_{n}_{split}_predictions[_rat].json`` and ``..._metrics...``)
    under ``output_dir``, written by rank 0 alone under a ``mesh``."""
    tp_active(mesh)  # a tp axis must come with its group
    if mesh is not None:
        device = mesh.device
    check_model_device(model, device)
    print(f"\n{'=' * 60}\nEpoch {epoch} | {split_name.upper()} Evaluation\n{'=' * 60}")
    predictions, metrics = generate_and_evaluate(
        model,
        dataset,
        annotations_path,
        batch_size=batch_size,
        max_length=max_length,
        temperature=temperature,
        top_p=top_p,
        decode=decode,
        beam_size=beam_size,
        seed=seed,
        db_store=db_store,
        top_k=top_k,
        top_i=top_i,
        mesh=mesh,
        decode_precision=decode_precision,
        device=device,
    )
    print(f"\nResults: {metrics}")
    if mesh is None or mesh.is_main:
        save_epoch_artifacts(predictions, metrics, output_dir, epoch, split_name, rat=rat)
    barrier(mesh)
    return metrics


def generate_test_caption_predictions(
    model,
    dataset,
    output_path: str = "results.json",
    batch_size: int = 32,
    max_length: int = 50,
    temperature: float = 0.0,
    top_p: float = 0.9,
    decode: str = "sample",
    beam_size: int = 4,
    db_store=None,
    top_k: int | None = None,
    top_i: int | None = None,
    decode_precision: str | None = None,
    seed: int = 0,
    device=DEFAULT_DEVICE,
) -> list[dict[str, Any]]:
    """Dump COCO-schema predictions ``[{"image_id": int, "caption": str}]``
    to ``output_path`` (the reference's ``results.json``)."""
    predictions = generate_predictions(
        model,
        dataset,
        batch_size=batch_size,
        max_length=max_length,
        temperature=temperature,
        top_p=top_p,
        decode=decode,
        beam_size=beam_size,
        seed=seed,
        db_store=db_store,
        top_k=top_k,
        top_i=top_i,
        decode_precision=decode_precision,
        device=device,
    )
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(predictions, f, indent=2)
    print(f"Predictions saved to: {output_path}")
    return predictions
