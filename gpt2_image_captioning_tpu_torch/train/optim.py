"""AdamW, the linear warmup schedule and global-norm clipping — the
counterpart of ``gpt2_image_captioning_tpu/train/optim.py``, on
``torch.optim``.

The JAX package writes torch's AdamW out by hand (decoupled weight decay,
bias-corrected moments, eps outside the square root); the port takes
``torch.optim.AdamW`` itself, with a ``LambdaLR`` whose multiplier is the
same linear warmup/decay at the 0-based optimizer step, and clips with
``torch.nn.utils.clip_grad_norm_``, whose ``max_norm / (norm + 1e-6)`` is the
JAX package's formula.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: float | None = 1.0
    num_warmup_steps: int = 0
    num_training_steps: int = 1


def linear_warmup_schedule(cfg: AdamWConfig, step: int) -> float:
    """HF ``get_linear_schedule_with_warmup``'s multiplier at the 0-based
    optimizer step (``LambdaLR``'s counter)."""
    if step < cfg.num_warmup_steps:
        return step / max(1, cfg.num_warmup_steps)
    return max(0.0, (cfg.num_training_steps - step)
               / max(1, cfg.num_training_steps - cfg.num_warmup_steps))


def make_optimizer(trainable, cfg: AdamWConfig):
    """``(torch.optim.AdamW, LambdaLR)`` over the leaves of ``trainable``,
    which become the optimizer's parameters (``requires_grad`` is set on
    them; they must be leaf tensors)."""
    params = [p.requires_grad_(True) for p in tree_leaves(trainable)]
    optimizer = torch.optim.AdamW(
        params, lr=cfg.learning_rate, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
        weight_decay=cfg.weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: linear_warmup_schedule(cfg, step)
    )
    return optimizer, scheduler


def clip_grad_norm(params: list[torch.Tensor], max_norm: float | None) -> torch.Tensor:
    """The global gradient norm before clipping; scales the gradients by
    ``min(1, max_norm / (norm + 1e-6))`` unless ``max_norm`` is None."""
    if max_norm is None:
        return torch.nn.utils.get_total_norm([p.grad for p in params if p.grad is not None])
    return torch.nn.utils.clip_grad_norm_(params, max_norm)
