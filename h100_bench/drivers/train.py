"""ClipCap training as ``config.yml`` states it: the step of
``train/loop.py::make_train_step`` (GPT-2 frozen, the transformer mapper
trained, AdamW, the traffic's ``compute_dtype``), fed batches of ``batch``
captions made on the device from the seed: ``caption_min`` … ``caption_max``
random tokens, then EOS, padded with EOS to ``caption_length`` (labels -100
and mask 0 on the padding), each with an N(0, 1) image embedding.  Every
step takes a fresh batch.

Set-up builds one train step with its weights and optimizer and drives it
through ``judge_steps`` steps on their own batches (the first compiles and
warms up everything); the window then runs the same object on.  End to end:
``train_captions_per_s``, the captions of every step of the window over its
seconds.  Correct: the reference follows those first steps from the same
initial weights on the same batches (:func:`reference.judge.reference_training`);
compared are the worst step's relative loss gap, and the worst leaf's gap
(:func:`reference.judge.leaf_gap`) of the first step's gradient as the
optimizer took it (its first moment after one step over 1 − beta1) and of
the parameters' change after the steps, each taken by published parameter
(a packed in_proj's q, k and v apart, :func:`reference.judge.parts`); those
whose reference gradient is under a thousandth of the median's are left
out (:func:`reference.judge.moving_leaves`).  The control: the
reference with fp8 operands in the program's place.

After the window, once the peak is read, the same object takes one more
step on the window's feed (the tail step).  The reference follows it from
the mapper and the optimizer's moments as the window left them (the
program's own state: the window's steps are too many to follow) at the
learning rate and the step count of the harness's own count of steps;
compared is the worst leaf's gap of its change, which holds the optimizer's
state, the schedule and the step's weight copies to account after the
window, where the first steps cannot.  Its loss is printed, not compared:
one forward's loss gap lies within five times of the sound runs' under the
fp8 control.
"""

from __future__ import annotations

import time

import torch

from h100_bench import faults, weights
from h100_bench import harness as H
from h100_bench.metrics.trace import Tracer
from h100_bench.reference import judge as J
from h100_bench.reference import model as R


def batches(tr: dict, cfg: dict, gen: torch.Generator, device):
    """An endless stream of seeded caption batches."""
    b, length, eos = tr["batch"], tr["caption_length"], cfg["eos_token_id"]
    pos = torch.arange(length, device=device)[None, :]
    while True:
        lens = torch.randint(tr["caption_min"], tr["caption_max"] + 1, (b, 1), generator=gen,
                             device=device) + 1
        tokens = torch.randint(0, eos, (b, length), generator=gen, device=device,
                               dtype=torch.int32)
        tokens = torch.where(pos >= lens - 1, eos, tokens).to(torch.int32)
        yield {"token_ids": tokens,
               "attention_mask": (pos < lens).to(torch.int32),
               "labels": torch.where(pos < lens, tokens, -100).to(torch.int32),
               "image_embedding": torch.randn((b, cfg["mapping"]["embed_dim"]), generator=gen,
                                              device=device)}


def unflatten(template, leaves: list):
    """A tree shaped like ``template`` holding ``leaves`` in its order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(template)


def run(cell: H.Cell) -> H.Outcome:
    from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32
    from gpt2_image_captioning_tpu_torch.train import loop, optim

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    mp, gpt = weights.captioner(cfg, cell.seed, dev, bf16=False)
    paths = [p for p, _ in weights.tree_paths(mp)]
    mp0 = [p.detach().clone() for p in weights.tree_leaves(mp)]
    trainable, frozen = {"mapping": mp}, {"gpt": gpt}
    opt = tr["optimizer"]
    opt_cfg = optim.AdamWConfig(learning_rate=opt["lr"], beta1=opt["beta1"], beta2=opt["beta2"],
                                eps=opt["eps"], weight_decay=opt["weight_decay"],
                                max_grad_norm=opt["max_grad_norm"], num_warmup_steps=0,
                                num_training_steps=opt["schedule_steps"])
    optimizer, scheduler = optim.make_optimizer(trainable, opt_cfg)
    policy = {"bfloat16": BF16, "float32": F32}[tr["compute_dtype"]]
    feed = batches(tr, cfg, weights.generator(cell.seed, 3, dev), dev)
    seconds = H.window_seconds(cell)
    tracer = Tracer() if cell.trace else None
    with faults.planted(cell.fault):
        step = loop.make_train_step(H.port_configs(cfg), opt_cfg, policy, device=dev)
        H.reset_peak(dev)
        first = [next(feed) for _ in range(tr["judge_steps"])]
        losses, grad_norms = [], None
        for i, b in enumerate(first):
            losses.append(float(step(trainable, optimizer, scheduler, frozen, b)[0]))
            if i == 0:  # the gradient as the optimizer took it, from its first moment
                moments = [optimizer.state[p]["exp_avg"] / (1 - opt["beta1"])
                           if p in optimizer.state else torch.zeros_like(p)
                           for p in weights.tree_leaves(mp)]
                grad_norms = J.part_norms(paths, moments)
        change = J.part_norms(paths, [p.detach() - p0
                                      for p, p0 in zip(weights.tree_leaves(mp), mp0)])
        H.synchronize(dev)
        if tracer:
            tracer.start()
        t0 = time.perf_counter()
        steps, stamps = 0, []
        while True:
            step(trainable, optimizer, scheduler, frozen, next(feed))
            steps += 1
            stamps.append(time.perf_counter())
            if stamps[-1] - t0 >= seconds:
                break
        H.synchronize(dev)
        elapsed = time.perf_counter() - t0
        win = tracer.stop() if tracer else None
        card = H.card_state(dev)
        peak = H.memory_peak(dev)
        # the tail step: the same object from the state the window left
        leaves = weights.tree_leaves(mp)
        before = [p.detach().clone() for p in leaves]
        state = [optimizer.state.get(p, {}) for p in leaves]
        moments = [s["exp_avg"].clone() if s else torch.zeros_like(p)
                   for s, p in zip(state, leaves)]
        squares = [s["exp_avg_sq"].clone() if s else torch.zeros_like(p)
                   for s, p in zip(state, leaves)]
        tail_batch = next(feed)
        tail_loss = float(step(trainable, optimizer, scheduler, frozen, tail_batch)[0])
        tail_change = J.part_norms(paths, [p.detach() - b for p, b in zip(leaves, before)])
    del step, optimizer, scheduler, trainable, state
    H.release(dev)

    lr = opt["lr"]
    n_sched = opt["schedule_steps"]

    def lr_at(i):
        return lr * max(0.0, (n_sched - i) / n_sched)

    ref = J.reference_training(mp0, paths, lambda ls: unflatten(mp, ls), gpt, cfg, first, opt,
                               lr_at)
    if cell.control:  # the reference in fp8 in the program's place
        ctl = J.reference_training(mp0, paths, lambda ls: unflatten(mp, ls), gpt, cfg, first, opt,
                                   lr_at, prec=R.Precision("fp8"))
        losses, grad_norms, change = ctl["losses"], ctl["grad_norms"], ctl["change"]
    index = tr["judge_steps"] + steps  # the tail step's place in the run, by the harness's count
    tail = J.reference_tail(before, moments, squares, index, paths,
                            lambda ls: unflatten(mp, ls), gpt, cfg, tail_batch, opt, lr_at(index))
    if cell.control:
        ctl = J.reference_tail(before, moments, squares, index, paths,
                               lambda ls: unflatten(mp, ls), gpt, cfg, tail_batch, opt,
                               lr_at(index), prec=R.Precision("fp8"))
        tail_loss, tail_change = ctl["loss"], ctl["change"]
    keep = J.moving_leaves(ref["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    grad_gap, g_at = J.leaf_gap(grad_norms, ref["grad_norms"], keep)
    change_gap, c_at = J.leaf_gap(change, ref["change"], keep)
    tail_change_gap, t_at = J.leaf_gap(tail_change, tail["change"], keep)
    lim = cell.limits
    names = J.part_names(paths, mp0)

    def leaf(i):
        return names[i] if i >= 0 else None

    notes = [f"losses {losses!r} reference {ref['losses']!r}; tail step {index}: loss "
             f"{tail_loss!r} reference {tail['loss']!r} (gap "
             f"{abs(tail_loss - tail['loss']) / abs(tail['loss'])!r})",
             f"leaves left out (gradient under a thousandth of the median): "
             f"{[p for p, k in zip(names, keep) if not k]}",
             f"worst gradient leaf {leaf(g_at)}, worst change leaf {leaf(c_at)}, worst tail "
             f"change leaf {leaf(t_at)}" + ("; control: fp8 reference" if cell.control else ""),
             H.pace("steps", t0, stamps), card]
    compared = {k: (v, lim[k]) for k, v in (
        ("loss_gap", loss_gap), ("grad_gap", grad_gap), ("change_gap", change_gap),
        ("tail_change_gap", tail_change_gap))}
    return H.Outcome(
        e2e={"train_captions_per_s": steps * tr["batch"] / elapsed},
        attempted=steps * tr["batch"], failed=0, window_start=t0, memory_peak_bytes=peak,
        compared=compared, trace=win,
        counts={"steps": steps, "batch": tr["batch"], "seconds": elapsed}, notes=notes)
