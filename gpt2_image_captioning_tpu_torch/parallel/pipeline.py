"""Pipeline-parallel training over a ``(dp, pp)`` mesh (GPipe) — the
counterpart of ``gpt2_image_captioning_tpu/parallel/pipeline.py``.

GPT-2's blocks are stored stacked on a leading layer dim
(``models/gpt2.py::stack_blocks``), so stage ``s`` of ``S`` owns the layer
slice ``[s·L/S, (s+1)·L/S)``: cutting the stacked tree over the ``pp`` axis
(:func:`pipeline_param_specs`, :func:`shard_stage_params`) is the stage
assignment.  Ranks lie on the grid as ``rank = d · pp + s``, the stages of
one dp index contiguous.

The port's schedule is GPipe written out over point-to-point messages
(``torch.distributed.send`` / ``recv``; under gloo CUDA tensors go through
the host), one process a rank, instead of the JAX package's one SPMD scan
with masking:

- the forward runs the M microbatches in order: stage 0 alone builds the
  prefix and embeds (its mapper, ``wte`` and ``wpe`` see the data), every
  stage runs its layers and sends the (mb, T, D) activation downstream, and
  the last stage alone runs LN_f and the vocab-chunked cross-entropy;
- the backward then runs the M microbatches in reverse: the last stage
  differentiates its loss, and each stage sends dL/dx of its received
  activation upstream, where it seeds the backward of the sender's output.
  Each received activation requires grad, so dL/dx reaches stage 0's mapper
  even with a frozen GPT-2, whose blocks have no weight gradients;
- block gradients stay stage-local; the replicated leaves' gradients (the
  mapper, the task prefix, ``wpe``, LN_f and the tied ``wte``, whose
  gradient comes from stage 0's embedding and the last stage's logits) sum
  over pp (``pipeline.py:218-231``), and everything sums over dp;
- the loss is each dp shard's nll over the global token count, summed over
  the ranks: the JAX ``captioner.loss_fn`` mean.

The bubble is GPipe's ``(S−1)/(M+S−1)``: raise ``num_microbatches`` to
amortise it.  pp targets depth scaling and tp width scaling
(``models/gpt2.py``); the two are separate meshes, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gpt2_image_captioning_tpu_torch.core.mesh import DATA_AXIS, GridMesh, grid_mesh
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves, tree_map
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX
from gpt2_image_captioning_tpu_torch.parallel.collectives import (
    Split, all_reduce, gather_tree, leaf_specs, psum_scalar, shard_tree, sum_tensors,
)
from gpt2_image_captioning_tpu_torch.train import optim

PIPE_AXIS = "pp"


@dataclasses.dataclass(frozen=True, kw_only=True)
class PipelineMesh(GridMesh):
    """The ``(dp, pp)`` mesh (``rank = dp_rank · pp + stage``): ``stage`` on
    the pp axis and ``pp_group`` (the stages of its dp index)."""

    AXIS = (PIPE_AXIS, "stage")
    pp: int
    stage: int
    pp_group: object


def create_pipeline_mesh(dp: int, pp: int, device=None) -> PipelineMesh:
    """The ``(dp, pp)`` mesh of this rank (:func:`core.mesh.grid_mesh`),
    with the JAX error's wording."""
    return grid_mesh(PipelineMesh, dp, pp, device, unit="devices")


# ---------------------------------------------------------------------------
# Stage slices
# ---------------------------------------------------------------------------

def pipeline_param_specs(ccfg: C.CaptionerConfig) -> tuple[dict, dict]:
    """(trainable, frozen) trees of how each leaf is cut over pp: GPT-2's
    stacked blocks on their leading layer dim, everything else replicated
    (None) — the mapper and the embeddings are small next to the blocks."""
    gpt = {"wte": None, "wpe": None, "ln_f": None, "blocks": Split(PIPE_AXIS, 0)}
    trainable: dict = {"mapping": None}
    if ccfg.task_prompt_ids:
        trainable["task_prefix"] = None
    frozen: dict = {}
    (frozen if ccfg.freeze_gpt_weights else trainable)["gpt"] = gpt
    return trainable, frozen


def _check_layers(ccfg: C.CaptionerConfig, n_stage: int) -> None:
    if ccfg.gpt2.n_layer % n_stage:
        raise ValueError(f"n_layer={ccfg.gpt2.n_layer} not divisible by pp={n_stage}")


def shard_stage_params(trainable: dict, frozen: dict, ccfg: C.CaptionerConfig,
                       mesh: PipelineMesh) -> tuple[dict, dict]:
    """This stage's (trainable, frozen) trees: its layers of GPT-2's blocks,
    the replicated leaves the full trees' own tensors."""
    _check_layers(ccfg, mesh.pp)
    specs = pipeline_param_specs(ccfg)
    return tuple(shard_tree(tree, spec, {PIPE_AXIS: mesh.pp}, {PIPE_AXIS: mesh.stage})
                 for tree, spec in zip((trainable, frozen), specs))


def gather_stage_params(tree: dict, ccfg: C.CaptionerConfig, mesh: PipelineMesh) -> dict:
    """A tree shaped like the trainable one (parameters, gradients or AdamW
    moments) with every stage's layers joined back whole; every stage of
    the dp index must call."""
    return gather_tree(tree, pipeline_param_specs(ccfg)[0], mesh.backend,
                       {PIPE_AXIS: mesh.pp_group}, {PIPE_AXIS: mesh.pp})


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _send(mesh: PipelineMesh, x: torch.Tensor, dst: int) -> None:
    x = x.detach().contiguous()
    dist.send(x.cpu() if mesh.backend == "gloo" else x, dst=dst)


def _recv(mesh: PipelineMesh, shape, dtype, src: int) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if mesh.backend == "gloo" else mesh.device)
    dist.recv(buf, src=src)
    return buf.to(mesh.device)


def _gpipe(ccfg: C.CaptionerConfig, mesh: PipelineMesh, policy: Policy, n_micro: int,
           trainable: dict, frozen: dict, batch: dict, use_kernels) -> torch.Tensor:
    """One GPipe forward and backward of this rank's dp shard ``batch``: the
    trainable leaves' ``.grad`` accumulate this stage's terms; returns this
    rank's loss term (nonzero on the last stage only)."""
    cfg = ccfg.gpt2
    gpt = C._gpt(trainable, frozen)
    batch = {k: torch.as_tensor(v, device=mesh.device) for k, v in batch.items()
             if k != "image_id"}
    b, n_tok = batch["labels"].shape
    if b % n_micro:
        raise ValueError(f"local batch {b} not divisible by microbatches {n_micro}")
    mb = b // n_micro
    p_len = ccfg.total_prefix_length
    shape = (mb, p_len + n_tok, cfg.n_embd)
    first, last = mesh.stage == 0, mesh.stage == mesh.pp - 1
    # the global batch's count: data, outside autograd
    count = torch.clamp(psum_scalar(mesh, (batch["labels"] != IGNORE_INDEX).sum()), min=1)
    mask = C.key_mask(batch["attention_mask"], p_len)
    loss = torch.zeros((), device=mesh.device)
    held = []
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        if first:  # the prefix and the embeddings, as forward_hidden starts
            micro = {k: v[rows] for k, v in batch.items()}
            x = G.add_positions(gpt, C.teacher_inputs(trainable, frozen, ccfg, micro, policy,
                                                      use_kernels), policy)
        else:
            x = _recv(mesh, shape, policy.compute_dtype, mesh.rank - 1).requires_grad_(True)
        y = G.run_blocks(gpt["blocks"], cfg, x, mask[rows], policy, ccfg.remat, use_kernels)
        if last:
            h = nn.layer_norm(gpt["ln_f"], y, cfg.layer_norm_epsilon)
            y = C.caption_nll(gpt, ccfg, h, batch["labels"][rows], policy)[0] / count
            loss += y.detach()
        else:
            _send(mesh, y, mesh.rank + 1)
        held.append((x, y))
    for x, y in reversed(held):
        if last:
            y.backward()
        else:
            y.backward(_recv(mesh, y.shape, y.dtype, mesh.rank + 1))
        if not first:
            _send(mesh, x.grad, mesh.rank - 1)
    return loss


def _combine(ccfg: C.CaptionerConfig, mesh: PipelineMesh, trainable: dict,
             loss: torch.Tensor) -> tuple[torch.Tensor, list[bool]]:
    """Sum the stages' gradients as the JAX ``_loss_and_grad`` does: block
    gradients over dp, replicated ones over pp and dp; the loss over every
    rank.  Returns (the loss, which leaves are stage slices)."""
    params = tree_leaves(trainable)
    staged = [s is not None for s in leaf_specs(trainable, pipeline_param_specs(ccfg)[0])]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sum_tensors(mesh.backend, mesh.dp_group, [p.grad for p, s in zip(params, staged) if s])
    loss = loss.reshape(1)
    sum_tensors(mesh.backend, mesh.group,
                [p.grad for p, s in zip(params, staged) if not s] + [loss])
    return loss[0], staged


def make_pipeline_loss_and_grad(ccfg: C.CaptionerConfig, mesh: PipelineMesh,
                                policy: Policy = F32, num_microbatches: int = 4,
                                use_kernels: bool | None = None):
    """``(trainable, frozen, batch) → (loss, grads)`` over a ``(dp, pp)`` mesh,
    the train step's inner product: ``trainable`` / ``frozen`` this stage's
    trees (:func:`shard_stage_params`), ``batch`` this rank's dp shard (the
    same on every stage of a dp index); ``grads`` shaped like ``trainable``
    (its stage's block slices), the same loss on every rank.  The leaves'
    ``.grad`` are left None."""
    _check_layers(ccfg, mesh.pp)

    def loss_and_grad(trainable, frozen, batch):
        params = tree_leaves(trainable)
        for p in params:
            p.requires_grad_(True)
            p.grad = None
        loss = _gpipe(ccfg, mesh, policy, num_microbatches, trainable, frozen, batch,
                      use_kernels)
        loss, _ = _combine(ccfg, mesh, trainable, loss)
        grads = tree_map(lambda p: p.grad.detach().clone(), trainable)
        for p in params:
            p.grad = None
        return loss, grads

    return loss_and_grad


def make_pipeline_train_step(ccfg: C.CaptionerConfig, opt_cfg: optim.AdamWConfig,
                             mesh: PipelineMesh, policy: Policy = F32,
                             num_microbatches: int = 4, use_kernels: bool | None = None):
    """The pipeline-parallel AdamW step over a ``(dp, pp)`` mesh, with
    :func:`train.loop.make_train_step`'s calling convention:
    ``step(trainable, optimizer, scheduler, frozen, batch, extra=None) →
    (loss, grad_norm)``, ``optimizer`` / ``scheduler`` from
    :func:`train.optim.make_optimizer` over this stage's ``trainable``
    (:func:`shard_stage_params`), which the step updates in place; ``batch``
    this rank's dp shard, which ``num_microbatches`` must divide.  The
    clip's norm sums the block slices' squares over pp once and counts each
    replicated leaf once."""
    _check_layers(ccfg, mesh.pp)

    def step(trainable, optimizer, scheduler, frozen, batch, extra=None):
        optimizer.zero_grad(set_to_none=True)
        loss = _gpipe(ccfg, mesh, policy, num_microbatches, trainable, frozen, batch,
                      use_kernels)
        loss, staged = _combine(ccfg, mesh, trainable, loss)
        grad_norm = optim.clip_grad_norm(
            tree_leaves(trainable), opt_cfg.max_grad_norm, staged,
            lambda x: all_reduce(mesh.backend, mesh.pp_group, x))
        optimizer.step()
        scheduler.step()
        return loss, grad_norm

    return step
