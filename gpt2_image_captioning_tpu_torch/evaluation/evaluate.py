"""Caption evaluation: the metrics container, reference loading, scoring
and the per-epoch artifacts — the counterpart of
``gpt2_image_captioning_tpu/evaluation/evaluate.py``, with the same
functions, file names (``epoch_{n}_{split}_predictions[_rat].json``,
``epoch_{n}_{split}_metrics[_rat].json``) and JSON.  Plain Python on the
host; the captions come from :mod:`evaluation.generation`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from gpt2_image_captioning_tpu_torch.evaluation.metrics import Bleu, Cider, Rouge


@dataclass
class EvalMetrics:
    """Container for caption evaluation metrics."""

    bleu_1: float
    bleu_2: float
    bleu_3: float
    bleu_4: float
    rouge_l: float
    cider: float

    def to_dict(self) -> dict[str, float]:
        return {
            "BLEU-1": self.bleu_1,
            "BLEU-2": self.bleu_2,
            "BLEU-3": self.bleu_3,
            "BLEU-4": self.bleu_4,
            "ROUGE-L": self.rouge_l,
            "CIDEr": self.cider,
        }

    def __str__(self) -> str:
        return (
            f"BLEU-1: {self.bleu_1:.4f} | BLEU-2: {self.bleu_2:.4f} | "
            f"BLEU-3: {self.bleu_3:.4f} | BLEU-4: {self.bleu_4:.4f} | "
            f"ROUGE-L: {self.rouge_l:.4f} | CIDEr: {self.cider:.4f}"
        )


def compute_caption_metrics(
    predictions: Mapping[int, Sequence[str]],
    references: Mapping[int, Sequence[str]],
) -> EvalMetrics:
    """Score predictions against references with BLEU/ROUGE-L/CIDEr.

    Both arguments map image_id → list of captions; predictions carry exactly
    one caption per image.  Only ids present in both are scored.
    """
    common = set(predictions.keys()) & set(references.keys())
    if not common:
        raise ValueError("No common image IDs found between predictions and references")
    preds = {k: list(predictions[k]) for k in common}
    refs = {k: list(references[k]) for k in common}

    bleu, _ = Bleu(4).compute_score(refs, preds)
    rouge, _ = Rouge().compute_score(refs, preds)
    cider, _ = Cider().compute_score(refs, preds)
    return EvalMetrics(
        bleu_1=bleu[0],
        bleu_2=bleu[1],
        bleu_3=bleu[2],
        bleu_4=bleu[3],
        rouge_l=rouge,
        cider=cider,
    )


def load_coco_references(annotations_path: str) -> dict[int, list[str]]:
    """image_id → reference captions from a COCO annotations JSON."""
    with open(annotations_path, "r") as f:
        coco = json.load(f)
    refs: dict[int, list[str]] = {}
    for ann in coco["annotations"]:
        refs.setdefault(ann["image_id"], []).append(ann["caption"])
    return refs


def evaluate_captions(
    predictions: list[dict[str, Any]],
    annotations_path: str,
) -> EvalMetrics:
    """Score a ``[{"image_id": int, "caption": str}]`` prediction list."""
    preds = {p["image_id"]: [p["caption"]] for p in predictions}
    return compute_caption_metrics(preds, load_coco_references(annotations_path))


def save_eval_summary(all_metrics: list[dict[str, Any]], output_path: str) -> None:
    with open(output_path, "w") as f:
        json.dump(all_metrics, f, indent=2)
    print(f"Evaluation summary saved to: {output_path}")


def save_epoch_artifacts(
    predictions: list[dict[str, Any]],
    metrics: EvalMetrics,
    output_dir: str,
    epoch: int,
    split_name: str,
    rat: bool = False,
) -> None:
    """Write the per-epoch predictions/metrics JSONs with the reference's
    filenames (``epoch_{n}_{split}_predictions[_rat].json`` etc.)."""
    os.makedirs(output_dir, exist_ok=True)
    suffix = "_rat" if rat else ""
    with open(
        os.path.join(output_dir, f"epoch_{epoch}_{split_name}_predictions{suffix}.json"), "w"
    ) as f:
        json.dump(predictions, f, indent=2)
    with open(
        os.path.join(output_dir, f"epoch_{epoch}_{split_name}_metrics{suffix}.json"), "w"
    ) as f:
        json.dump(
            {
                "epoch": epoch,
                "split": split_name,
                "num_images": len(predictions),
                **metrics.to_dict(),
            },
            f,
            indent=2,
        )


def per_image_metrics(
    predictions: list[dict[str, Any]],
    annotations_path: str,
) -> dict[int, dict[str, float]]:
    """Per-image BLEU-4 / ROUGE-L / CIDEr (the scorers' per-item outputs),
    keyed by image_id — feeds the results viewer's metric chips."""
    refs_all = load_coco_references(annotations_path)
    preds = {p["image_id"]: [p["caption"]] for p in predictions}
    common = [i for i in preds if i in refs_all]
    if not common:
        return {}
    gts = {i: refs_all[i] for i in common}
    res = {i: preds[i] for i in common}
    _, bleu_items = Bleu(4).compute_score(gts, res)
    _, rouge_items = Rouge().compute_score(gts, res)
    _, cider_items = Cider().compute_score(gts, res)
    return {
        img_id: {
            "BLEU-4": float(bleu_items[3][i]),
            "ROUGE-L": float(rouge_items[i]),
            "CIDEr": float(cider_items[i]),
        }
        for i, img_id in enumerate(gts)
    }
