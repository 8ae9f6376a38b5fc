"""The port's ops/nn.py against the JAX package's, in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.ops import nn as JNN
from gpt2_image_captioning_tpu_torch.ops import attention as TATT
from gpt2_image_captioning_tpu_torch.ops import nn as TNN


def _rng(seed=0):
    return np.random.default_rng(seed)


def _dense():
    r = _rng(1)
    p = {"w": r.normal(size=(24, 40)).astype(np.float32), "b": r.normal(size=40).astype(np.float32)}
    x = r.normal(size=(3, 5, 24)).astype(np.float32)
    return (JNN.dense({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
            TNN.dense({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)))


def _layer_norm():
    r = _rng(2)
    p = {"scale": r.normal(size=24).astype(np.float32),
         "bias": r.normal(size=24).astype(np.float32)}
    x = (3.0 * r.normal(size=(4, 7, 24)) + 1.5).astype(np.float32)
    return (JNN.layer_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)),
            TNN.layer_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)))


def _gelu_new():
    x = (4.0 * _rng(3).normal(size=(6, 33))).astype(np.float32)
    return JNN.gelu_new(jnp.asarray(x)), TNN.gelu_new(torch.from_numpy(x))


def _heads():
    x = _rng(4).normal(size=(2, 5, 12)).astype(np.float32)
    j = JNN.merge_heads(JNN.split_heads(jnp.asarray(x), 3))
    t = TNN.merge_heads(TNN.split_heads(torch.from_numpy(x), 3))
    np.testing.assert_array_equal(
        np.asarray(JNN.split_heads(jnp.asarray(x), 3)),
        TNN.split_heads(torch.from_numpy(x), 3).numpy(),
    )
    return j, t


def _attention(causal=False, masked=False, q_offset=0, tq=6, tk=6):
    r = _rng(5)
    q = r.normal(size=(2, 3, tq, 8)).astype(np.float32)
    k = r.normal(size=(2, 3, tk, 8)).astype(np.float32)
    v = r.normal(size=(2, 3, tk, 8)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, tk), np.int32)
        mask[0, tk - 2:] = 0
    kw = dict(causal=causal, q_offset=q_offset)
    j = JNN.attention_xla(*(jnp.asarray(a) for a in (q, k, v)),
                          key_mask=None if mask is None else jnp.asarray(mask), **kw)
    t = TATT.mha(*(torch.from_numpy(a) for a in (q, k, v)),
                 key_mask=None if mask is None else torch.from_numpy(mask), **kw)
    return j, t


CASES = {
    "dense": _dense,
    "layer_norm": _layer_norm,
    "gelu_new": _gelu_new,
    "split_merge_heads": _heads,
    "attention": _attention,
    "attention_causal": lambda: _attention(causal=True),
    "attention_key_mask": lambda: _attention(masked=True),
    "attention_causal_q_offset": lambda: _attention(causal=True, masked=True, q_offset=4, tq=3,
                                                    tk=7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nn_matches_jax_f32(case):
    want, got = CASES[case]()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)

