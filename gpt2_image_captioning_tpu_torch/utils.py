"""Plotting, worker sizing and parameter counts — the counterpart of
``gpt2_image_captioning_tpu/utils.py``.

matplotlib is imported inside the two plotting functions, so the package
imports without it; :func:`plotting_available` says whether they can run.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Any

from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves


def plotting_available() -> bool:
    """Whether matplotlib, which the two curve functions need, is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def save_loss_curves(loss_values: list[float], filepath: str) -> None:
    """PNG of training loss per epoch."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(range(1, len(loss_values) + 1), loss_values, marker="o", label="Training Loss")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.set_title("Training Loss Over Epochs")
    ax.legend()
    ax.grid(True)
    fig.savefig(filepath)
    plt.close(fig)


_METRIC_STYLE = {
    "BLEU-1": ("tab:blue", "--"),
    "BLEU-2": ("tab:blue", "-."),
    "BLEU-3": ("tab:blue", ":"),
    "BLEU-4": ("tab:blue", "-"),
    "ROUGE-L": ("tab:green", "-"),
    "CIDEr": ("tab:red", "-"),
}


def save_eval_metric_curves(
    metrics_history: list[dict],
    filepath: str,
    title: str = "Evaluation Metrics Over Epochs",
) -> None:
    """Two-panel PNG: BLEU-1..4 left, ROUGE-L/CIDEr right."""
    if not metrics_history:
        return
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [m["epoch"] for m in metrics_history]
    fig, (ax_bleu, ax_rest) = plt.subplots(1, 2, figsize=(14, 5))
    for name, (color, style) in _METRIC_STYLE.items():
        if name not in metrics_history[0]:
            continue
        ax = ax_bleu if name.startswith("BLEU") else ax_rest
        ax.plot(epochs, [m[name] for m in metrics_history], label=name, color=color,
                linestyle=style)
    for ax, sub in ((ax_bleu, "BLEU Scores"), (ax_rest, "ROUGE-L, CIDEr")):
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Score")
        ax.set_title(sub)
        ax.legend()
        ax.grid(True)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(filepath)
    plt.close(fig)


def get_max_workers(batch_size: int) -> int:
    """Thread-pool sizing for host-side work: min(4×cores, batch)."""
    return min((os.cpu_count() or 1) * 4, batch_size)


def count_parameters(tree: Any) -> int:
    """Total number of scalar parameters in a tree of tensors."""
    return sum(t.numel() for t in tree_leaves(tree))


def count_model_parameters(model: Any) -> tuple[int, int]:
    """(trainable, total) parameter counts for an ImageCaptioningModel."""
    t = count_parameters(model.trainable)
    return t, t + count_parameters(model.frozen)
