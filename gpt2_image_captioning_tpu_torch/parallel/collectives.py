"""Explicit collectives over the port's ``(dp, tp)`` mesh — the counterpart
of ``gpt2_image_captioning_tpu/parallel/collectives.py``, whose ``axis``
argument becomes the mesh's process subgroups.

Over the dp axis (``mesh.dp_group``), each rank passes its own shard and the
result is the same on every rank:

- :func:`psum_scalar` / :func:`pmean_scalar` — a per-shard sum / mean
  reduced over the ranks (token counts, losses);
- :func:`all_gather_batch` — every dp shard, concatenated in dp order on the
  batch axis (predictions, embeddings, the continuous engine's packed
  output);
- :func:`psum_tensors` — an in-place sum of a list of tensors over the ranks
  in one collective a dtype (the train step's gradients).

Over the tp axis (``mesh.tp_group``), Megatron's conjugate pair and the
gather, as autograd functions (PyTorch's ``torch.distributed.nn`` all-reduce
transposes to an all-reduce, the wrong conjugate for a row-parallel output,
and its all-gather's backward needs global rank 0 in the group):

- :func:`copy_to_tp` — identity forward, all-reduce of the gradient backward
  (the input of a column-parallel product);
- :func:`reduce_from_tp` — all-reduce forward, identity backward (the output
  of a row-parallel product, the vocab-parallel embedding);
- :func:`gather_last_tp` — the tp slices concatenated on the last dim, whose
  backward takes the rank's slice (the decode step's logits).

Over the sp axis of a ``(dp, sp)`` mesh (``parallel/sequence.py``, whose
mesh has ``sp_group`` and ``sp_rank``), the sequence-parallel pair:

- :func:`gather_seq_sp` — the ranks' (B, T/sp, ...) chunks concatenated on
  dim 1 in sp order, whose backward reduce-scatters the gradient over sp
  in float32 onto the rank's chunk (the JAX ``all_gather``'s transpose);
- :func:`ring_permute` — the tensor of sp index ``s - 1`` (round the ring),
  whose backward sends the gradient the other way (``ppermute``'s
  transpose).

:class:`Split`, :func:`shard_tree` and :func:`gather_tree` cut a tree of full
tensors into a rank's slices and join the slices again.

Gloo takes CPU tensors only: under a ``gloo`` group a CUDA tensor is copied
to the host, reduced or gathered there, and copied back; under ``nccl`` it
stays on the card.  Reductions of bfloat16 tensors run in float32.  An axis
without a group (size 1) returns its input.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.mesh import Mesh, tp_active


def _staged(backend: str | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend reads it: the host under gloo."""
    return x.cpu() if backend == "gloo" else x


def all_reduce(backend: str | None, group, x: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` (None: ``x`` itself) as a new tensor on
    ``x``'s device in ``x``'s dtype; floats reduce in float32."""
    if group is None:
        return x
    dtype = torch.float32 if x.is_floating_point() else x.dtype
    buf = _staged(backend, x.detach().to(dtype, copy=True))
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(device=x.device, dtype=x.dtype)


def sum_tensors(backend: str | None, group, tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over ``group``, in place: the tensors of one dtype are
    packed into one buffer and reduced by one collective."""
    if group is None:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ in by_dtype.values():
        flat = _staged(backend, torch.cat([t.reshape(-1) for t in group_]))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat.to(group_[0].device)
        offset = 0
        for t in group_:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def psum_scalar(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` (this rank's shard, any shape) over the dp ranks: a
    0-d tensor on ``x``'s device."""
    return all_reduce(mesh.backend, mesh.dp_group, x.sum())


def pmean_scalar(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean over the dp ranks of each rank's mean of ``x`` (the global
    mean when the shards have one size)."""
    return psum_scalar(mesh, x.mean()) / mesh.dp


def all_gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every dp rank's ``x`` (one shape on every rank) concatenated in dp
    order on dim 0, on ``x``'s device."""
    if mesh.dp_group is None:
        return x
    src = _staged(mesh.backend, x).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.dp)]
    dist.all_gather(parts, src, group=mesh.dp_group)
    return torch.cat(parts).to(x.device)


def psum_tensors(mesh: Mesh, tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over the dp ranks, in place (:func:`sum_tensors`)."""
    sum_tensors(mesh.backend, mesh.dp_group, tensors)


# ---------------------------------------------------------------------------
# The tp axis
# ---------------------------------------------------------------------------

class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh.backend, ctx.mesh.tp_group, g), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(mesh.backend, mesh.tp_group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.lo, ctx.n = mesh.tp_rank * x.shape[-1], x.shape[-1]
        src = _staged(mesh.backend, x).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.tp)]
        dist.all_gather(parts, src, group=mesh.tp_group)
        return torch.cat(parts, dim=-1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n].contiguous(), None


def copy_to_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every tp rank) as the input of a column-parallel
    product: the gradients the ranks' slices send back are summed."""
    return _CopyToTP.apply(x, mesh) if tp_active(mesh) else x


def reduce_from_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the tp ranks of each rank's partial ``x``; its gradient
    reaches every rank whole."""
    return _ReduceFromTP.apply(x, mesh) if tp_active(mesh) else x


def gather_last_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' ``x`` (one shape) concatenated on the last dim in tp
    order; the gradient of the rank's own columns flows back."""
    return _GatherLastTP.apply(x, mesh) if tp_active(mesh) else x


def max_over_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the tp ranks (no gradient)."""
    return all_reduce(mesh.backend, mesh.tp_group, x, op=dist.ReduceOp.MAX)


def psum_tp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the tp ranks (no gradient)."""
    return all_reduce(mesh.backend, mesh.tp_group, x)


# ---------------------------------------------------------------------------
# Slicing trees over an axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf is cut over the mesh axis ``axis``: ``dim`` in as many
    contiguous blocks as the axis has ranks, block i on the rank of index i,
    inside each of ``groups`` equal parts of the dim (c_attn's q, k and v,
    so a rank holds the same heads of each).  ``pad``: the dim is first
    padded with zeros to a multiple of the axis size (the vocabulary rows)."""

    axis: str
    dim: int
    groups: int = 1
    pad: bool = False


def cut(x: torch.Tensor, split: Split, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of ``x`` under ``split``, a new contiguous tensor."""
    if split.pad and x.shape[split.dim] % n:
        extra = n - x.shape[split.dim] % n
        shape = list(x.shape)
        shape[split.dim] = extra
        x = torch.cat([x, x.new_zeros(shape)], dim=split.dim)
    parts = [g.chunk(n, dim=split.dim)[i] for g in x.chunk(split.groups, dim=split.dim)]
    return torch.cat(parts, dim=split.dim).contiguous()


def join(blocks: list[torch.Tensor], split: Split, size: int | None = None) -> torch.Tensor:
    """The inverse of :func:`cut` over all its blocks, in order; ``size``
    trims a padded dim back to its length."""
    g = split.groups
    parts = [torch.cat([b.chunk(g, dim=split.dim)[j] for b in blocks], dim=split.dim)
             for j in range(g)]
    out = torch.cat(parts, dim=split.dim)
    return out.narrow(split.dim, 0, size) if size is not None else out


def _map_specs(fn, tree, specs, path: str = ""):
    """``fn(path, leaf, split)`` over the leaves of ``tree`` with their
    ``/``-joined key paths and their :class:`Split` in ``specs`` (a spec that
    is not a container applies to the whole subtree)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs.get(k) if isinstance(specs, dict) else specs,
                              f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, v, specs[i] if isinstance(specs, (list, tuple)) else specs,
                           f"{path}/{i}")
                for i, v in enumerate(tree)]
    return fn(path, tree, specs)


def leaf_specs(tree, specs) -> list:
    """Each leaf's :class:`Split` (or None), in ``core.tree.tree_leaves``'
    order."""
    out: list = []
    _map_specs(lambda _, __, split: out.append(split), tree, specs)
    return out


def shard_tree(tree, specs, sizes: dict[str, int], ranks: dict[str, int]):
    """This rank's slices of ``tree`` under ``specs`` (a tree of
    :class:`Split` or None over the same keys; a None subtree replicates its
    leaves).  ``sizes`` / ``ranks`` give each axis's size and the rank's
    index on it.  Replicated leaves are the tree's own tensors, not copies,
    so an in-place update of the sharded tree reaches them."""
    def leaf(_, x, split):
        if split is None or sizes[split.axis] == 1:
            return x
        return cut(x, split, sizes[split.axis], ranks[split.axis])

    return _map_specs(leaf, tree, specs)


def gather_tree(tree, specs, backend: str | None, groups: dict[str, object],
                sizes: dict[str, int], trims: dict[str, int] | None = None):
    """The full tree of the slices ``tree`` holds on each rank of an axis,
    gathered over the axis's group (every rank of it must call; replicated
    leaves are returned as they are).  ``trims``: the true length of each
    padded leaf, by its ``/``-joined key path."""
    def leaf(path, x, split):
        if split is None or sizes[split.axis] == 1:
            return x
        src = _staged(backend, x.detach()).contiguous()
        blocks = [torch.empty_like(src) for _ in range(sizes[split.axis])]
        dist.all_gather(blocks, src, group=groups[split.axis])
        size = (trims or {}).get(path) if split.pad else None
        return join(blocks, split, size).to(x.device)

    return _map_specs(leaf, tree, specs)


# ---------------------------------------------------------------------------
# The sp axis
# ---------------------------------------------------------------------------

class _GatherSeqSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        src = _staged(mesh.backend, x).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.sp)]
        dist.all_gather(parts, src, group=mesh.sp_group)
        return torch.cat(parts, dim=1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        parts = [_staged(mesh.backend, c.float()).contiguous()
                 for c in g.chunk(mesh.sp, dim=1)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=mesh.sp_group)
        return out.to(device=g.device, dtype=g.dtype), None


def _exchange(mesh, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and return what global rank ``src``
    sends, as one posted pair (a blocking send on every rank at once can
    deadlock under gloo)."""
    out = _staged(mesh.backend, x.detach()).contiguous()
    buf = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, dst), dist.P2POp(dist.irecv, buf, src)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(x.device)


def _sp_peer(mesh, step: int) -> int:
    """The global rank ``step`` places ahead of this one round its sp ring
    (the ranks ``dp_rank · sp + s``)."""
    return mesh.dp_rank * mesh.sp + (mesh.sp_rank + step) % mesh.sp


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _exchange(mesh, x, _sp_peer(mesh, 1), _sp_peer(mesh, -1))

    @staticmethod
    def backward(ctx, g):
        return _exchange(ctx.mesh, g, _sp_peer(ctx.mesh, -1), _sp_peer(ctx.mesh, 1)), None


def gather_seq_sp(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every sp rank's ``x`` (B, T/sp, ...) concatenated on dim 1 in sp
    order; the gradient of the whole sums over sp onto each rank's chunk."""
    return _GatherSeqSP.apply(x, mesh) if mesh.sp > 1 else x


def ring_permute(mesh, x: torch.Tensor) -> torch.Tensor:
    """The ``x`` of the previous rank round the sp ring (each rank sends its
    own to the next); the gradient goes back to the sender."""
    return _RingPermute.apply(x, mesh) if mesh.sp > 1 else x
