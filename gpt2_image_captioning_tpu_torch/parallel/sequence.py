"""Sequence-parallel training over a ``(dp, sp)`` mesh (Megatron-SP) — the
counterpart of ``gpt2_image_captioning_tpu/parallel/sequence.py``, for
long-context fine-tuning where a rank's activations, not its FLOPs, bind.

One process a rank, as the port's other meshes: ranks lie on the grid as
``rank = d · sp + s``, the sp ranks of one dp index contiguous (the JAX
``reshape(dp, sp)``).  The batch is this rank's dp shard (the ``Batcher``'s
contiguous rows), the same on every sp rank of its dp index; the
parameters are replicated.

- Every activation is sharded on the sequence dim: each rank embeds the
  whole (replicated) sequence, keeps its chunk of T/sp rows and their
  ``wpe`` rows, and runs LayerNorm, the MLP, the projections and the loss
  head on that chunk alone.
- Attention is the only mixing op.  In the all-gather form each block
  gathers the (B, T/sp, D) keys and values over sp
  (:func:`parallel.collectives.gather_seq_sp`, whose backward is the
  reduce-scatter) and attends its queries through ``ops.attention.mha`` at
  ``q_offset = s · T/sp`` with the whole key mask: the flash kernel on the
  card, ``attention_xla`` on the CPU.  With ``ring=True`` the keys and
  values stay sharded and rotate (``parallel/ring.py``).
- The shifted loss crosses chunk boundaries: the rank's row r predicts the
  global label r + 1.  Labels are replicated over sp, so each rank slices
  its shifted window locally; there is no halo exchange.  The nll goes
  through ``ops.xent.xent_sum`` over the global token count.
- The loss and every gradient are summed over every rank of the mesh after
  the backward, never inside it (a sum inside the differentiated function
  would count each gradient sp times, as ``parallel/pipeline.py`` notes).

A GPT-2 that is frozen still gives the mapper its gradient: the prefix rows
live in the first chunk, and the other ranks' queries reach them only
through dK and dV — the gather's reduce-scatter, or ``ring_permute``'s
backward.  The sequence (prefix + caption) is padded to a multiple of sp
by :func:`pad_batch_for_sp`: the loss and gradients do not change.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.mesh import DATA_AXIS, GridMesh, grid_mesh
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves, tree_map
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX, xent_sum
from gpt2_image_captioning_tpu_torch.parallel.collectives import (
    all_reduce, gather_seq_sp, sum_tensors,
)
from gpt2_image_captioning_tpu_torch.parallel.ring import ring_attention

SEQ_AXIS = "sp"


@dataclasses.dataclass(frozen=True, kw_only=True)
class SequenceMesh(GridMesh):
    """The ``(dp, sp)`` mesh (``rank = dp_rank · sp + sp_rank``): ``sp_rank``
    on the sp axis and ``sp_group`` (the sp ranks of its dp index)."""

    AXIS = (SEQ_AXIS, "sp_rank")
    sp: int
    sp_rank: int
    sp_group: object


def create_sp_mesh(dp: int, sp: int, device=None) -> SequenceMesh:
    """The ``(dp, sp)`` mesh of this rank (:func:`core.mesh.grid_mesh`): its
    error says "mesh {dp}x{sp} needs {n} ranks, have {m}"."""
    return grid_mesh(SequenceMesh, dp, sp, device)


def _sp_block(bp: dict, cfg: G.GPT2Config, x: torch.Tensor, *, key_mask: torch.Tensor,
              q_offset: int, policy: Policy, mesh: SequenceMesh, ring: bool) -> torch.Tensor:
    """One transformer block over the rank's (B, Tc, D) chunk: the math of
    ``models.gpt2._block``, whose one collective is in attention — the K/V
    gather over sp, or the ring."""
    h = nn.layer_norm(bp["ln_1"], x, cfg.layer_norm_epsilon)
    qkv = nn.dense(bp["attn"]["c_attn"], h, policy)
    q3, k3, v3 = torch.split(qkv, cfg.n_embd, dim=-1)  # each (B, Tc, D)
    q4 = nn.split_heads(q3, cfg.n_head)
    if ring:
        a4 = ring_attention(q4, nn.split_heads(k3, cfg.n_head), nn.split_heads(v3, cfg.n_head),
                            mesh=mesh, q_offset=q_offset, key_mask=key_mask, causal=True,
                            policy=policy)
    else:
        a4 = mha(q4, nn.split_heads(gather_seq_sp(mesh, k3), cfg.n_head),
                 nn.split_heads(gather_seq_sp(mesh, v3), cfg.n_head), causal=True,
                 key_mask=key_mask, q_offset=q_offset, policy=policy)
    x = x + nn.dense(bp["attn"]["c_proj"], nn.merge_heads(a4), policy)
    h = nn.layer_norm(bp["ln_2"], x, cfg.layer_norm_epsilon)
    h = nn.gelu_new(nn.dense(bp["mlp"]["c_fc"], h, policy))
    return x + nn.dense(bp["mlp"]["c_proj"], h, policy)


def _shard_loss(ccfg: C.CaptionerConfig, mesh: SequenceMesh, policy: Policy, ring: bool,
                trainable: dict, frozen: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's nll over its sequence chunk, and the global token count
    (summed over every rank of the mesh, outside autograd).  ``batch``: the
    rank's dp shard as tensors on its device, its sequence a multiple of
    sp."""
    cfg = ccfg.gpt2
    gpt = C._gpt(trainable, frozen)
    p_len = ccfg.total_prefix_length
    inputs = C.teacher_inputs(trainable, frozen, ccfg, batch, policy)
    b, t_len = inputs.shape[:2]
    ignore = torch.full((b, p_len), IGNORE_INDEX, dtype=batch["labels"].dtype,
                        device=inputs.device)
    labels = torch.cat([ignore, batch["labels"]], dim=1)
    mask = C.key_mask(batch["attention_mask"], p_len)
    if t_len % mesh.sp:
        raise ValueError(f"sequence length {t_len} not divisible by sp={mesh.sp}; "
                         "pad the batch (make_sp_loss_and_grad does this automatically)")
    tc = t_len // mesh.sp
    offset = mesh.sp_rank * tc
    rows = slice(offset, offset + tc)
    x = (inputs[:, rows].float() + gpt["wpe"][rows][None].float()).to(policy.compute_dtype)
    blocks = gpt["blocks"]
    for i in range(blocks["ln_1"]["scale"].shape[0]):
        x = _sp_block(G._layer(blocks, i), cfg, x, key_mask=mask, q_offset=offset,
                      policy=policy, mesh=mesh, ring=ring)
    h = nn.layer_norm(gpt["ln_f"], x, cfg.layer_norm_epsilon)
    # the shifted labels: the rank's row r (global offset + r) predicts the
    # global label offset + r + 1; the last row, and the -100s, predict nothing
    shifted = torch.cat([labels[:, 1:], ignore[:, :1]], dim=1)
    lab2 = shifted[:, rows].reshape(-1)
    nll = xent_sum(policy.cast(h).reshape(-1, h.shape[-1]),
                   gpt["wte"].to(policy.compute_dtype), lab2)
    count = all_reduce(mesh.backend, mesh.group, (lab2 != IGNORE_INDEX).sum())
    return nll, count


def pad_batch_for_sp(batch: dict, p_len: int, sp: int) -> dict:
    """The batch with its captions padded so that prefix + caption divides
    sp: the appended rows carry token 0, label -100 and attention mask 0 —
    no loss and no attention weight.  The batch itself when nothing needs
    padding."""
    L = batch["token_ids"].shape[1]
    extra = -(-(p_len + L) // sp) * sp - (p_len + L)
    if extra == 0:
        return batch

    def pad(x, value):
        x = torch.as_tensor(x)
        return torch.cat([x, x.new_full((x.shape[0], extra), value)], dim=1)

    return {**batch, "token_ids": pad(batch["token_ids"], 0),
            "labels": pad(batch["labels"], IGNORE_INDEX),
            "attention_mask": pad(batch["attention_mask"], 0)}


def make_sp_loss_and_grad(ccfg: C.CaptionerConfig, mesh: SequenceMesh, policy: Policy = F32,
                          ring: bool = False):
    """``(trainable, frozen, batch) → (loss, grads)`` over a ``(dp, sp)``
    mesh: the parameters replicated, ``batch`` this rank's dp shard (the
    same on every sp rank of its dp index), padded by
    :func:`pad_batch_for_sp`; activations sequence-sharded inside.
    ``grads`` is shaped like ``trainable``, the same on every rank, as is the
    loss; the leaves' ``.grad`` are left None.  ``ring=True`` swaps the
    per-layer K/V gather for ring attention (``parallel/ring.py``): the same
    math, O(T/sp) keys a rank.  The kernels run where the tensors are on the
    card (the flash kernel in the all-gather form's blocks and the
    mapper's)."""

    def loss_and_grad(trainable, frozen, batch):
        batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in batch.items()
                 if k != "image_id"}
        batch = pad_batch_for_sp(batch, ccfg.total_prefix_length, mesh.sp)
        params = tree_leaves(trainable)
        for p in params:
            p.requires_grad_(True)
            p.grad = None
        nll, count = _shard_loss(ccfg, mesh, policy, ring, trainable, frozen, batch)
        local = nll / torch.clamp(count, min=1)
        local.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach() for p in params]
        loss = local.detach().reshape(1)
        sum_tensors(mesh.backend, mesh.group, grads + [loss])
        for p in params:
            p.grad = None
        it = iter(grads)
        return loss[0], tree_map(lambda _: next(it), trainable)

    return loss_and_grad
