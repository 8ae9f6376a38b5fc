"""The training loop — the counterpart of ``make_train_step``,
``_group_microbatches`` and ``train`` in
``gpt2_image_captioning_tpu/train/loop.py``.

One step takes a host batch (numpy arrays from :class:`data.dataset.Batcher`)
to the device, runs the teacher-forced mean loss forward and backward
(through the flash-attention kernel on the card), clips, and steps AdamW and
its schedule.  With accumulation the batch carries a leading (accum, micro)
shape and the step sums the micro-batches' mean losses and gradients and
divides both by ``accum``, as the JAX package does.  It returns the loss and
the gradient norm as device tensors, so the host does not wait for the
device.

Data parallelism (``mesh``, :mod:`core.mesh`): each rank steps on its
contiguous shard of the global batch.  The JAX step's loss is Σ nll / Σ
count over the *global* (micro-)batch, so each micro-batch first sums its
real-token count over the ranks (data, outside autograd), then
differentiates its local nll over that global count; the gradients (and the
loss) are summed over the ranks before the global-norm clip.  Every rank
then takes the same AdamW step on the same summed gradients, so the
parameters stay bit-identical across ranks.

:func:`train` is the epoch loop around it, with the JAX function's
signature, history dict and artifacts: ``model_epoch_{n}.{npz|pt}`` and
``optimizer_epoch_{n}.npz`` (the JAX package's ``AdamWState`` layout, so a
run resumes across the two packages), ``best_model_epoch_{n}`` by
validation CIDEr, the per-epoch evaluation JSONs, ``val_metrics_summary.json``,
the curves and ``logs/metrics.jsonl``.  Under a dp mesh each rank's
``Batcher`` yields its shard, and rank 0 alone writes the files, followed by
a barrier.

Retrieval-augmented training (:func:`train_rat`, or ``train(rat_cfg=,
db_store=)``): with a :class:`retrieval.exact.DeviceVectorStore` the step
retrieves on the card (its arrays are the step's side input, as the JAX
package's ``extra``); with a host store (HNSW, flat, persistent) a thread
retrieves each batch one batch ahead of the step (:func:`_prefetched`).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import re
import threading
import time
from typing import Any

import numpy as np
import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.logging import MetricsLogger, StepTimer, profile_trace
from gpt2_image_captioning_tpu_torch.core.mesh import barrier, refuse_tp
from gpt2_image_captioning_tpu_torch.core.precision import Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_leaves
from gpt2_image_captioning_tpu_torch.data.dataset import Batcher, CocoDataset
from gpt2_image_captioning_tpu_torch.evaluation.evaluate import save_eval_summary
from gpt2_image_captioning_tpu_torch.evaluation.generation import (
    _indexed,
    check_model_device,
    evaluate_epoch,
)
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX
from gpt2_image_captioning_tpu_torch.parallel.collectives import psum_scalar, psum_tensors
from gpt2_image_captioning_tpu_torch.train import checkpoint, optim
from gpt2_image_captioning_tpu_torch.utils import (
    plotting_available,
    save_eval_metric_curves,
    save_loss_curves,
)


def make_train_step(
    cfg: C.CaptionerConfig,
    opt_cfg: optim.AdamWConfig,
    policy: Policy,
    grad_accum_steps: int = 1,
    device=DEFAULT_DEVICE,
    rat_cfg=None,
    fused_retrieval: bool = False,
    mesh=None,
):
    """Build ``step(trainable, optimizer, scheduler, frozen, batch, extra=None)
    → (loss, grad_norm)``.  ``optimizer``/``scheduler`` come from
    :func:`train.optim.make_optimizer` over ``trainable``, which the step
    updates in place.  ``batch``: numpy arrays or tensors (token_ids, labels,
    attention_mask, image_embedding; ``image_id`` is dropped), moved to
    ``device`` — the card unless the caller asks for the CPU.

    With ``rat_cfg`` (:class:`models.rat.RATConfig`) the step is RAT's: with
    ``fused_retrieval`` it retrieves from ``extra``, a device store's
    ``arrays()`` (:func:`models.rat.loss_fn_fused`); without, the batch
    carries ``retrieved_embeddings`` (:func:`models.rat.loss_fn`).

    ``mesh``: a dp :class:`core.mesh.Mesh` whose rank this is; ``batch`` is
    then the rank's shard of the global batch (the ``Batcher``'s with the
    rank's coordinates), the loss divides by the global token count and the
    step sums the gradients over the ranks (module docstring).  ``extra``
    is replicated: each rank passes its own store's arrays."""
    device = resolve_device(device)
    refuse_tp(mesh)
    if rat_cfg is not None:
        from gpt2_image_captioning_tpu_torch.models import rat as R

    def micro_loss(trainable, frozen, batch, extra):
        if rat_cfg is None:
            s, c = C.loss_fn(trainable, frozen, cfg, batch, policy)
        elif fused_retrieval:
            s, c = R.loss_fn_fused(trainable, frozen, cfg, rat_cfg, batch, extra, policy)
        else:
            s, c = R.loss_fn(trainable, frozen, cfg, rat_cfg, batch, policy)
        if mesh is not None:  # the global batch's count: data, outside autograd
            c = psum_scalar(mesh, c.detach())
        return s / torch.clamp(c, min=1)

    def step(trainable, optimizer, scheduler, frozen, batch, extra=None):
        params = tree_leaves(trainable)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k != "image_id"}
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss = micro_loss(trainable, frozen, batch, extra)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=device)
            for i in range(grad_accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                l = micro_loss(trainable, frozen, micro, extra)
                l.backward()
                loss += l.detach()
            loss /= grad_accum_steps
            for p in params:
                if p.grad is not None:
                    p.grad /= grad_accum_steps
        if mesh is not None:  # sum the rank-local terms of the global mean
            loss = loss.reshape(1)
            psum_tensors(mesh, [p.grad for p in params if p.grad is not None] + [loss])
            loss = loss[0]
        grad_norm = optim.clip_grad_norm(params, opt_cfg.max_grad_norm)
        optimizer.step()
        scheduler.step()
        return loss, grad_norm

    return step


def _prefetched(iterable, transform, depth: int = 2):
    """``transform`` of each item, computed by a thread up to ``depth`` items
    ahead of the consumer, in order: the next batch's host-store retrieval
    runs while the card computes this one.  An exception in the thread
    re-raises in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                q.put(transform(item))
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def _group_microbatches(batches: list[dict], accum: int) -> dict:
    """Stack ``accum`` micro-batches along a new leading axis, padding the
    final group with all-ignored dummies (zero loss and gradient)."""
    while len(batches) < accum:
        dummy = {k: np.copy(v) for k, v in batches[-1].items()}
        dummy["labels"] = np.full_like(dummy["labels"], IGNORE_INDEX)
        batches.append(dummy)
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _latest_checkpoint(outputs_dir: str) -> tuple[int, str] | None:
    """(epoch, file name) of the newest ``model_epoch_{n}.{npz|pt}``."""
    found = sorted(
        (int(m.group(1)), f)
        for f in os.listdir(outputs_dir)
        if (m := re.match(r"model_epoch_(\d+)\.(npz|pt)$", f))
    )
    return found[-1] if found else None


def train(
    train_dataset: CocoDataset,
    model: C.ImageCaptioningModel,
    batch_size: int,
    num_epochs: int,
    num_workers: int = 4,  # accepted and ignored, as in the JAX package: batching is vectorized
    learning_rate: float = 1e-4,
    num_warmup_steps: int = 0,
    save_every_epoch: int = 5,
    outputs_dir: str = "checkpoints",
    grad_accum_steps: int = 1,
    val_dataset: CocoDataset | None = None,
    val_annotations_path: str | None = None,
    eval_every_epoch: int = 1,
    eval_batch_size: int | None = None,
    eval_max_length: int = 50,
    eval_temperature: float = 0.0,
    eval_top_p: float = 0.9,
    eval_decode_precision: str | None = None,
    mesh=None,
    seed: int = 0,
    checkpoint_format: str = "npz",
    log_dir: str = "logs",
    remat: bool = False,
    rat_cfg=None,
    db_store=None,
    save_optimizer_state: bool = True,
    resume: bool = False,
    stop_after_epochs: int | None = None,
    profile_dir: str | None = None,
    device=DEFAULT_DEVICE,
) -> dict[str, Any]:
    """Train the captioner's trainable tree in place; returns the JAX
    function's history dict (``epoch_losses``, ``val_metrics``,
    ``best_val_cider``, ``best_epoch``, ``step_timing``), the losses and
    metrics of the epochs this call ran.

    AdamW at ``learning_rate`` with the linear warmup/decay schedule over
    ``steps_per_epoch * num_epochs`` steps, counting micro-batches even
    under accumulation, as the JAX package (and the reference) does.  With
    ``grad_accum_steps`` > 1 an epoch's trailing partial group is padded
    with all-ignored micro-batches and the epoch's average divides by the
    real micro-batches only.  Losses stay on the device during an epoch and
    are read once at its end.  Every ``save_every_epoch`` epochs and at the
    last one: ``model_epoch_{n}.{checkpoint_format}`` and (with
    ``save_optimizer_state``) ``optimizer_epoch_{n}.npz``; every
    ``eval_every_epoch`` epochs with a ``val_dataset``: greedy (or sampled,
    at ``eval_temperature``) captions at ``eval_decode_precision``, scored
    against ``val_annotations_path``, with ``best_model_epoch_{n}`` saved at
    each new best CIDEr.

    ``resume=True`` continues from the newest ``model_epoch_{n}`` and
    ``optimizer_epoch_{n}`` in ``outputs_dir`` (written by either package);
    ``stop_after_epochs`` bounds the epochs this call runs while the
    schedule still spans ``num_epochs``.  ``profile_dir`` records a
    ``torch.profiler`` trace of the first epoch's second optimizer step.
    ``remat=True`` recomputes each GPT-2 block in the backward
    (``CaptionerConfig.remat``).  ``device``: where the model lives, the
    card unless the caller asks for the CPU.  ``rat_cfg`` and ``db_store``
    (both or neither; ``model`` a RAT model) train retrieval-augmented, and
    each evaluation retrieves from ``db_store`` at ``rat_cfg``'s depths.

    ``mesh``: a dp :class:`core.mesh.Mesh`, the same call made on every rank
    (``device`` is the mesh's).  Each rank's ``Batcher`` yields its shard of
    every global batch of ``batch_size``, the steps sum over the ranks, and
    the evaluation decodes each rank's rows and gathers them; rank 0 alone
    writes the checkpoints, ``metrics.jsonl``, TensorBoard, the evaluation
    files and the curves, and a barrier follows each write.  ``resume``
    loads the same files on every rank.  ``tp > 1`` raises.
    """
    refuse_tp(mesh)
    if (rat_cfg is None) != (db_store is None):
        raise ValueError("rat_cfg and db_store go together: pass both for RAT, or neither")
    if mesh is not None:
        device = mesh.device
    device = check_model_device(model, device)
    main = mesh is None or mesh.is_main
    if val_dataset is not None and val_annotations_path is None:
        raise ValueError("val_annotations_path is required when val_dataset is provided")
    os.makedirs(outputs_dir, exist_ok=True)
    eval_dir = os.path.join(outputs_dir, "eval_results")
    os.makedirs(eval_dir, exist_ok=True)
    eval_batch_size = eval_batch_size or batch_size
    cfg = dataclasses.replace(model.cfg, remat=True) if remat else model.cfg

    if mesh is None:
        batcher = Batcher(train_dataset, batch_size, seed=seed)
    else:
        batcher = Batcher(train_dataset, batch_size, seed=seed, process_index=mesh.rank,
                          process_count=mesh.dp)
    steps_per_epoch = batcher.steps_per_epoch  # micro-batches per epoch
    opt_cfg = optim.AdamWConfig(
        learning_rate=learning_rate,
        num_warmup_steps=num_warmup_steps,
        # micro-batches x epochs, accumulation or not (the reference's count)
        num_training_steps=steps_per_epoch * num_epochs,
    )
    from gpt2_image_captioning_tpu_torch.retrieval.exact import DeviceVectorStore

    fused_retrieval = isinstance(db_store, DeviceVectorStore)
    extra = None
    if fused_retrieval:
        if _indexed(db_store.device) != _indexed(device):
            raise ValueError(f"the store is on {db_store.device}, the model on {device}")
        extra = db_store.arrays()

    def host_retrieve(batch: dict) -> dict:
        """A host store's retrieval for the batch, attached to it."""
        from gpt2_image_captioning_tpu_torch.models.rat import retrieve

        retrieved = retrieve(rat_cfg, db_store, batch["image_embedding"])
        return dict(batch, retrieved_embeddings=np.asarray(retrieved, np.float32))

    step_fn = make_train_step(cfg, opt_cfg, model.policy, grad_accum_steps, device=device,
                              rat_cfg=rat_cfg, fused_retrieval=fused_retrieval, mesh=mesh)

    start_epoch = 0
    opt_state = None
    latest = _latest_checkpoint(outputs_dir) if resume else None
    if latest is not None:
        start_epoch, ckpt_file = latest
        model.load_saved_parameters(os.path.join(outputs_dir, ckpt_file))
        opt_file = os.path.join(outputs_dir, f"optimizer_epoch_{start_epoch}.npz")
        if os.path.exists(opt_file):
            opt_state = checkpoint.load_pytree(opt_file)
        print(f"Resumed from epoch {start_epoch} ({ckpt_file})")
    trainable, frozen = model.trainable, model.frozen
    optimizer, scheduler = optim.make_optimizer(trainable, opt_cfg)
    if opt_state is not None:
        optim.restore_adamw_state(optimizer, scheduler, trainable, opt_state)

    logger = MetricsLogger(log_dir) if main else None
    timer = StepTimer()
    epoch_loss_values: list[float] = []
    val_metrics_history: list[dict[str, Any]] = []
    best_val_cider, best_epoch = -1.0, 0
    global_step = 0
    ckpt_ext = "pt" if checkpoint_format == "pt" else "npz"

    def run_group(group) -> torch.Tensor:
        timer.start()
        side = () if extra is None else (extra,)  # the fused store's arrays
        loss, _ = step_fn(trainable, optimizer, scheduler, frozen, group, *side)
        timer.stop()
        return loss

    try:
        end_epoch = num_epochs
        if stop_after_epochs is not None:
            end_epoch = min(num_epochs, start_epoch + stop_after_epochs)
        for epoch in range(start_epoch, end_epoch):
            losses: list[torch.Tensor] = []  # on the device until the epoch ends
            group_real_micro: list[int] = []  # real (non-padded) micro-batches per group
            pending: list[dict] = []
            t_epoch = time.perf_counter()
            batch_iter = batcher.epoch(epoch)
            if rat_cfg is not None and not fused_retrieval:
                batch_iter = _prefetched(batch_iter, host_retrieve)
            for batch in batch_iter:
                if grad_accum_steps == 1:
                    group = batch
                else:
                    pending.append(batch)
                    if len(pending) < grad_accum_steps:
                        continue
                    group = _group_microbatches(pending, grad_accum_steps)
                    pending = []
                # exactly one post-warm-up optimizer step of the first epoch
                with profile_trace(profile_dir if main and epoch == start_epoch
                                   and len(losses) == 1 else None):
                    losses.append(run_group(group))
                group_real_micro.append(grad_accum_steps)
            if pending:  # trailing partial accumulation group
                group_real_micro.append(len(pending))
                losses.append(run_group(_group_microbatches(pending, grad_accum_steps)))
            global_step += len(losses)

            losses_np = torch.stack(losses).cpu().tolist()  # the epoch's one host read
            if main:
                for i, lf in enumerate(losses_np):
                    logger.add_scalar("loss/train_step", lf, global_step - len(losses_np) + i + 1)
            # each group's loss is sum(real micro losses) / accum and the padded
            # tail adds 0: undo the 1/accum and divide by the real micro-batches
            avg_loss = sum(losses_np) * grad_accum_steps / max(sum(group_real_micro), 1)
            epoch_loss_values.append(avg_loss)
            dt = time.perf_counter() - t_epoch
            print(f"Epoch {epoch + 1} completed. Average Loss: {avg_loss:.4f} "
                  f"({len(losses_np)} steps, {dt:.1f}s)")
            if main:
                logger.add_scalar("loss/train_epoch", avg_loss, epoch + 1)
            # the steps changed the live tensors in place: the decode copies are stale
            model.drop_decode_caches()

            if (save_every_epoch > 0 and (epoch + 1) % save_every_epoch == 0) or (
                epoch + 1
            ) == num_epochs:
                path = os.path.join(outputs_dir, f"model_epoch_{epoch + 1}.{ckpt_ext}")
                if main:
                    checkpoint.save_captioner(path, trainable, model.cfg)
                    print(f"Model checkpoint saved at {path}")
                    if save_optimizer_state:
                        checkpoint.save_pytree(
                            os.path.join(outputs_dir, f"optimizer_epoch_{epoch + 1}.npz"),
                            optim.adamw_state(optimizer, trainable),
                        )
                barrier(mesh)

            evaluate = eval_every_epoch > 0 and (epoch + 1) % eval_every_epoch == 0
            if evaluate and val_dataset is not None:
                metrics = evaluate_epoch(
                    model,
                    val_dataset,
                    val_annotations_path,
                    epoch=epoch + 1,
                    split_name="val",
                    batch_size=eval_batch_size,
                    max_length=eval_max_length,
                    temperature=eval_temperature,
                    top_p=eval_top_p,
                    output_dir=eval_dir,
                    rat=rat_cfg is not None,
                    db_store=db_store,
                    top_k=getattr(rat_cfg, "top_k", None),
                    top_i=getattr(rat_cfg, "top_i", None),
                    decode_precision=eval_decode_precision,
                    mesh=mesh,
                    device=device,
                )
                val_metrics_history.append(
                    {"epoch": epoch + 1, "loss": avg_loss, **metrics.to_dict()})
                if main:
                    logger.add_scalars(
                        {
                            "CIDEr/val": metrics.cider,
                            "BLEU-1/val": metrics.bleu_1,
                            "BLEU-4/val": metrics.bleu_4,
                            "ROUGE-L/val": metrics.rouge_l,
                        },
                        epoch + 1,
                    )
                # every rank scored the same gathered captions: the same best
                if metrics.cider > best_val_cider:
                    best_val_cider, best_epoch = metrics.cider, epoch + 1
                    best_path = os.path.join(outputs_dir,
                                             f"best_model_epoch_{best_epoch}.{ckpt_ext}")
                    if main:
                        checkpoint.save_captioner(best_path, trainable, model.cfg)
                        print(f"New best model! CIDEr: {best_val_cider:.4f} "
                              f"(saved to {best_path})")
                    barrier(mesh)

        plots = plotting_available()
        if main:
            if plots:
                save_loss_curves(epoch_loss_values, os.path.join(outputs_dir, "loss_curve.png"))
            else:
                print("matplotlib is not installed: loss_curve.png and val_metrics_curve.png "
                      "are skipped")
            if val_metrics_history:
                save_eval_summary(
                    val_metrics_history, os.path.join(eval_dir, "val_metrics_summary.json")
                )
                if plots:
                    save_eval_metric_curves(
                        val_metrics_history,
                        os.path.join(eval_dir, "val_metrics_curve.png"),
                        title="Validation Metrics Over Epochs",
                    )
        barrier(mesh)
    finally:
        if logger is not None:
            logger.close()

    print("\n" + "=" * 60)
    print("Training complete.")
    print(f"Best validation CIDEr: {best_val_cider:.4f} at epoch {best_epoch}")
    print(f"Step timing: {timer.summary()}")
    print("=" * 60)
    return {
        "epoch_losses": epoch_loss_values,
        "val_metrics": val_metrics_history,
        "best_val_cider": best_val_cider,
        "best_epoch": best_epoch,
        "step_timing": timer.summary(),
    }


def train_rat(
    train_dataset: CocoDataset,
    model,
    db_store,
    top_k: int,
    top_i: int,
    batch_size: int,
    num_epochs: int,
    **kwargs,
) -> dict[str, Any]:
    """Retrieval-augmented training with the reference's ``train_rat``
    signature: :func:`train` with the store and the retrieval depths.
    ``model`` is a :class:`models.rat.RetrievalAugmentedTransformer` (its
    ``rcfg`` gives the aggregation; ``top_k`` / ``top_i`` here override the
    depths)."""
    rcfg = dataclasses.replace(model.rcfg, top_k=top_k, top_i=top_i)
    return train(train_dataset, model, batch_size=batch_size, num_epochs=num_epochs,
                 rat_cfg=rcfg, db_store=db_store, **kwargs)
