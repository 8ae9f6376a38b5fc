"""The port's vocab-chunked cross-entropy against the JAX package's
``xent_sum`` and against both packages' ``cross_entropy_loss``, its oracle:
V 293 in chunks of 64 (the last chunk ragged), float32.  Tolerances: values
1e-5 relative, gradients 1e-5 (float32, summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.ops import xent as JX
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.ops import xent as TX

N, D, V, CHUNK = 21, 32, 293, 64


def _inputs(all_ignored=False):
    rng = np.random.default_rng(0)
    h = rng.normal(size=(N, D)).astype(np.float32)
    wte = (0.5 * rng.normal(size=(V, D))).astype(np.float32)
    labels = rng.integers(0, V, size=N).astype(np.int32)
    labels[[2, 7, 19]] = -100
    labels[5] = V - 1  # a gold id in the ragged last chunk
    if all_ignored:
        labels[:] = -100
    return h, wte, labels


def _torch(h, wte, labels, chunk=CHUNK):
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(wte).requires_grad_()
    loss = TX.xent_sum(th, tw, torch.from_numpy(labels), chunk)
    loss.backward()
    return loss.detach().numpy(), th.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("all_ignored", [False, True], ids=["labels", "all_ignored"])
def test_xent_sum_matches_jax(all_ignored):
    h, wte, labels = _inputs(all_ignored)
    want, (dh, dw) = jax.value_and_grad(
        lambda a, b: JX.xent_sum(a, b, jnp.asarray(labels), CHUNK), argnums=(0, 1)
    )(jnp.asarray(h), jnp.asarray(wte))
    got, got_dh, got_dw = _torch(h, wte, labels)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dh, np.asarray(dh), atol=1e-5)
    np.testing.assert_allclose(got_dw, np.asarray(dw), atol=1e-5)
    if all_ignored:
        assert got == 0.0 and not got_dh.any() and not got_dw.any()


def test_xent_sum_matches_cross_entropy_loss():
    """The oracle: full logits, shifted labels.  Row i of h predicts label
    i + 1 of a (1, N + 1) sequence whose first label is a placeholder."""
    h, wte, labels = _inputs()
    logits = np.concatenate([h @ wte.T, np.zeros((1, V), np.float32)])[None]
    seq = np.concatenate([[-100], labels]).astype(np.int32)[None]
    got, _, _ = _torch(h, wte, labels)
    t_sum, t_count = TG.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(seq))
    j_sum, j_count = JG.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(seq))
    assert int(t_count) == int(j_count) == int((labels != -100).sum())
    np.testing.assert_allclose(float(t_sum), float(j_sum), rtol=1e-5)
    np.testing.assert_allclose(got, float(t_sum), rtol=1e-5)
    # one chunk holding the whole vocabulary (the default chunk is wider than V)
    np.testing.assert_allclose(_torch(h, wte, labels, TX.DEFAULT_CHUNK)[0], got, rtol=1e-6)


def test_no_dwte_for_a_frozen_embedding(monkeypatch):
    """With ``wte`` frozen the backward runs two products per chunk (the
    logits again and dh), not three: no dwte is computed."""
    h, wte, labels = _inputs()
    calls = []
    real = TX.nn.dot_f32
    monkeypatch.setattr(TX.nn, "dot_f32", lambda a, b: calls.append(1) or real(a, b))
    n_chunks = -(-V // CHUNK)
    for trainable in (False, True):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(wte).requires_grad_(trainable)
        loss = TX.xent_sum(th, tw, torch.from_numpy(labels), CHUNK)
        calls.clear()
        loss.backward()
        assert len(calls) == (3 if trainable else 2) * n_chunks
        assert (tw.grad is not None) == trainable
