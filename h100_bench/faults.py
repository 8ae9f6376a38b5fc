"""Faults planted under the timed path, to show that ``correct`` catches
them (the CPU tests in ``h100_bench/tests`` and the fault readings on the
card, ``run.py --fault``).  Each is a context manager that patches the port
where the fault would arise and restores it on exit.

- ``token``: a token altered where it is produced: every decode step's
  output is bent (greedy tokens moved by one at every step whose cache index
  is 1 modulo 3; emitted logits raised at one fixed id, which the argmax and
  the draw after the step then take).
- ``unchanged``: a train step that returns its state unchanged.
- ``half_batch``: a train step that leaves out half of the batch and takes
  the mean over the rest.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("token", "unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str | None):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    with {"token": _token, "unchanged": _unchanged, "half_batch": _half_batch}[name]():
        yield


@contextlib.contextmanager
def _patched(module, attr: str, wrap):
    orig = getattr(module, attr)
    setattr(module, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


@contextlib.contextmanager
def _token():
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    def wrap(step):
        def bent(packed, x0, k_cache, v_cache, idx, **kw):
            out = step(packed, x0, k_cache, v_cache, idx, **kw)
            first = out[0]
            if first.is_floating_point():  # emitted logits
                first = first.clone()
                first[:, 1234 % first.shape[1]] += 100.0
            elif int(idx) % 3 == 1:
                vocab = packed["wte"].shape[0]
                first = ((first.long() + 1) % vocab).to(first.dtype)
            return (first, *out[1:])
        return bent

    with _patched(DS, "fused_decode_step", wrap):
        yield


@contextlib.contextmanager
def _unchanged():
    from gpt2_image_captioning_tpu_torch.train import loop

    def wrap(make):
        def make_step(*a, **kw):
            make(*a, **kw)

            def step(trainable, optimizer, scheduler, frozen, batch, extra=None):
                dev = next(iter(batch.values())).device
                return torch.zeros((), device=dev), torch.zeros((), device=dev)
            return step
        return make_step

    with _patched(loop, "make_train_step", wrap):
        yield


@contextlib.contextmanager
def _half_batch():
    from gpt2_image_captioning_tpu_torch.train import loop

    def wrap(make):
        def make_step(*a, **kw):
            inner = make(*a, **kw)

            def step(trainable, optimizer, scheduler, frozen, batch, extra=None):
                half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return inner(trainable, optimizer, scheduler, frozen, half, extra)
            return step
        return make_step

    with _patched(loop, "make_train_step", wrap):
        yield
