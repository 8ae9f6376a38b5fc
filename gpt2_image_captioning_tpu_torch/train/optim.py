"""AdamW, the linear warmup schedule and global-norm clipping — the
counterpart of ``gpt2_image_captioning_tpu/train/optim.py``, on
``torch.optim``.

The JAX package writes torch's AdamW out by hand (decoupled weight decay,
bias-corrected moments, eps outside the square root); the port takes
``torch.optim.AdamW`` itself, with a ``LambdaLR`` whose multiplier is the
same linear warmup/decay at the 0-based optimizer step, and clips with
``torch.nn.utils.clip_grad_norm_``, whose ``max_norm / (norm + 1e-6)`` is the
JAX package's formula.

:func:`adamw_state` and :func:`restore_adamw_state` carry the optimizer's
state across checkpoints in the JAX package's ``AdamWState`` layout —
``{"step": int32, "mu": tree, "nu": tree}``, torch's ``exp_avg`` /
``exp_avg_sq`` under the parameters' tree paths — so an
``optimizer_epoch_{n}.npz`` resumes in either package.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.tree import (
    flatten_with_paths,
    tree_leaves,
    unflatten_from_paths,
)


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


def clip_grad_norm(params: list[torch.Tensor], max_norm: float | None,
                   sharded: list[bool] | None = None, shard_sum=None) -> torch.Tensor:
    """The global gradient norm before clipping; scales the gradients by
    ``min(1, max_norm / (norm + 1e-6))`` unless ``max_norm`` is None.

    Under model parallelism (tp slices, pipeline stages) ``sharded`` marks
    the params that are one rank's slice of a leaf and ``shard_sum`` sums a
    0-d tensor over that axis: the norm then counts the slices' squares
    summed over the axis and each replicated leaf once, the JAX
    ``clip_by_global_norm`` over the whole tree (``optim.py:63-74``), the
    same on every rank of the axis."""
    if sharded is None:
        if max_norm is None:
            return torch.nn.utils.get_total_norm([p.grad for p in params if p.grad is not None])
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    sq = {True: torch.zeros((), device=params[0].device),
          False: torch.zeros((), device=params[0].device)}
    for p, cut in zip(params, sharded):
        if p.grad is not None:
            sq[cut] = sq[cut] + torch.square(p.grad.float()).sum()
    norm = torch.sqrt(sq[False] + shard_sum(sq[True]))
    if max_norm is not None:
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(scale.to(p.grad.dtype))
    return norm


def adamw_state(optimizer: torch.optim.Optimizer, trainable) -> dict:
    """``optimizer``'s AdamW state over ``trainable`` as the JAX package's
    ``AdamWState`` tree: ``{"step": int32 scalar (optimizer steps taken),
    "mu": first moments, "nu": second moments}``, the moments float32 CPU
    tensors shaped like ``trainable`` (zeros, and step 0, before the first
    step)."""
    flat = flatten_with_paths(trainable)
    mu, nu, steps = {}, {}, set()
    for path, p in flat.items():
        state = optimizer.state.get(p)
        if state:
            steps.add(int(state["step"]))
            mu[path] = state["exp_avg"].detach().to("cpu", torch.float32).clone()
            nu[path] = state["exp_avg_sq"].detach().to("cpu", torch.float32).clone()
        else:
            steps.add(0)
            mu[path] = torch.zeros(p.shape, dtype=torch.float32)
            nu[path] = torch.zeros(p.shape, dtype=torch.float32)
    if len(steps) != 1:
        raise ValueError(f"the parameters have taken different numbers of steps: {sorted(steps)}")
    return {"step": torch.tensor(steps.pop(), dtype=torch.int32),
            "mu": unflatten_from_paths(mu), "nu": unflatten_from_paths(nu)}


def restore_adamw_state(optimizer: torch.optim.Optimizer, scheduler, trainable,
                        state: dict) -> None:
    """Load an ``AdamWState`` tree (:func:`adamw_state`'s, or the JAX
    package's from ``load_pytree``) into ``optimizer`` over ``trainable``,
    and set ``scheduler`` (the ``LambdaLR`` of :func:`make_optimizer`) to
    its step, so the learning rate resumes where the run stopped.  Raises
    on moments whose paths or shapes differ from ``trainable``'s."""
    step = int(state["step"])
    flat = flatten_with_paths(trainable)
    mu, nu = flatten_with_paths(state["mu"]), flatten_with_paths(state["nu"])
    for name, moments in (("mu", mu), ("nu", nu)):
        if set(moments) != set(flat):
            raise ValueError(f"optimizer state {name} does not match the parameters: missing "
                             f"{sorted(set(flat) - set(moments))}, unexpected "
                             f"{sorted(set(moments) - set(flat))}")
    for path, p in flat.items():
        m, v = (torch.as_tensor(t[path]) for t in (mu, nu))
        if tuple(m.shape) != tuple(p.shape) or tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"optimizer state for {path}: shape {tuple(m.shape)}, parameter "
                             f"{tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": m.to(p.device, torch.float32).clone(),
            "exp_avg_sq": v.to(p.device, torch.float32).clone(),
        }
    scheduler.last_epoch = step
    for group, base_lr, fn in zip(optimizer.param_groups, scheduler.base_lrs,
                                  scheduler.lr_lambdas):
        group["lr"] = base_lr * fn(step)
    scheduler._last_lr = [group["lr"] for group in optimizer.param_groups]
