"""Explicit collectives over the dp axis of a :class:`core.mesh.Mesh` — the
counterpart of ``gpt2_image_captioning_tpu/parallel/collectives.py``, whose
``axis`` argument waits for a second mesh axis (tensor parallelism).

Each rank passes its own shard; the result is the same on every rank:

- :func:`psum_scalar` / :func:`pmean_scalar` — a per-shard sum / mean
  reduced over the ranks (token counts, losses);
- :func:`all_gather_batch` — every rank's shard, concatenated in rank
  order on the batch axis (predictions, embeddings, the continuous
  engine's packed output);
- :func:`psum_tensors` — an in-place sum of a list of tensors over the
  ranks in one collective a dtype (the train step's gradients).

Gloo takes CPU tensors only: under a ``gloo`` group a CUDA tensor is copied
to the host, reduced or gathered there, and copied back; under ``nccl`` it
stays on the card.  A one-rank mesh without a group returns its input.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.mesh import Mesh


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend reads it: the host under gloo."""
    return x.cpu() if mesh.backend == "gloo" else x


def psum_scalar(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (this rank's shard, any shape) over every rank: a 0-d
    tensor on ``x``'s device."""
    s = x.sum()
    if mesh.group is None:
        return s
    buf = _staged(mesh, s).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.to(x.device)


def pmean_scalar(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of each rank's mean of ``x`` (the global mean
    when the shards have one size)."""
    return psum_scalar(mesh, x.mean()) / mesh.dp


def all_gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated in rank order
    on dim 0, on ``x``'s device."""
    if mesh.group is None:
        return x
    src = _staged(mesh, x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def psum_tensors(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over every rank, in place: the tensors of one dtype
    are packed into one buffer and reduced by one collective."""
    if mesh.group is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _staged(mesh, torch.cat([t.reshape(-1) for t in group]))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = flat.to(group[0].device)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
