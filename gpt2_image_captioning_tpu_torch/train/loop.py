"""The train step — the counterpart of ``make_train_step`` and
``_group_microbatches`` in ``gpt2_image_captioning_tpu/train/loop.py``.

One step takes a host batch (numpy arrays from :class:`data.dataset.Batcher`)
to the device, runs the teacher-forced mean loss forward and backward
(through the flash-attention kernel on the card), clips, and steps AdamW and
its schedule.  With accumulation the batch carries a leading (accum, micro)
shape and the step sums the micro-batches' mean losses and gradients and
divides both by ``accum``, as the JAX package does.  It returns the loss and
the gradient norm as device tensors, so the host does not wait for the
device.  The epoch loop ``train()``, evaluation, meshes and RAT are not
ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX
from gpt2_image_captioning_tpu_torch.train import optim


def make_train_step(
    cfg: C.CaptionerConfig,
    opt_cfg: optim.AdamWConfig,
    policy: Policy,
    grad_accum_steps: int = 1,
    device=DEFAULT_DEVICE,
):
    """Build ``step(trainable, optimizer, scheduler, frozen, batch) →
    (loss, grad_norm)``.  ``optimizer``/``scheduler`` come from
    :func:`train.optim.make_optimizer` over ``trainable``, which the step
    updates in place.  ``batch``: numpy arrays or tensors (token_ids, labels,
    attention_mask, image_embedding; ``image_id`` is dropped), moved to
    ``device`` — the card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def step(trainable, optimizer, scheduler, frozen, batch):
        params = tree_leaves(trainable)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k != "image_id"}
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss = C.mean_loss(trainable, frozen, cfg, batch, policy)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=device)
            for i in range(grad_accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                l = C.mean_loss(trainable, frozen, cfg, micro, policy)
                l.backward()
                loss += l.detach()
            loss /= grad_accum_steps
            for p in params:
                if p.grad is not None:
                    p.grad /= grad_accum_steps
        grad_norm = optim.clip_grad_norm(params, opt_cfg.max_grad_norm)
        optimizer.step()
        scheduler.step()
        return loss, grad_norm

    return step


def _group_microbatches(batches: list[dict], accum: int) -> dict:
    """Stack ``accum`` micro-batches along a new leading axis, padding the
    final group with all-ignored dummies (zero loss and gradient)."""
    while len(batches) < accum:
        dummy = {k: np.copy(v) for k, v in batches[-1].items()}
        dummy["labels"] = np.full_like(dummy["labels"], IGNORE_INDEX)
        batches.append(dummy)
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
