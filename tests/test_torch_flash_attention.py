"""The port's flash attention against the JAX package's Pallas kernel (run in
interpret mode): the plain twin's forward and ``FlashAttention``'s gradients,
in float32, over causal and bidirectional attention, ragged lengths with a
key mask, a static q_offset (with Tq < Tk), several blocks (T 200), head
dims 8 and 24, the paths' 64 and 96 at their ragged lengths and the wide
mapper's 128, 160 and 200 (the last served zero-padded to 208); then
``mha`` on the CPU against the JAX package's ``mha``, and the CUDA
kernel's launch plan.

Tolerances: the forward to 1e-5 and the gradients to 1e-4 (both sides are
float32; they differ in summation order and in the online against the plain
softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.ops import attention as JA
from gpt2_image_captioning_tpu.ops import nn as JNN
from gpt2_image_captioning_tpu_torch.ops import attention as TA

# B, H, Tq, Tk, hd, causal, key mask, q_offset
CASES = {
    "causal": (2, 3, 16, 16, 8, True, False, 0),
    "bidirectional": (2, 3, 16, 16, 8, False, False, 0),
    "odd_masked_causal": (3, 2, 13, 13, 24, True, True, 0),
    "odd_masked_bidirectional": (3, 2, 11, 11, 8, False, True, 0),
    "q_offset": (2, 2, 5, 12, 8, True, True, 7),
    "multi_block_t200": (1, 2, 200, 200, 24, True, True, 0),
    # the paths' head dims at their ragged lengths: ViT-B/16's T 197 at hd 64,
    # the mapper's T 25 at hd 96; a causal tail of 15 queries after 50 keys
    "ragged_t197_hd64": (1, 2, 197, 197, 64, False, True, 0),
    "mapper_t25_hd96": (2, 2, 25, 25, 96, False, False, 0),
    "causal_q_offset_tq_lt_tk_hd64": (2, 2, 15, 65, 64, True, True, 50),
    # the mapper's heads at GPT-2 medium, large and XL (1024, 1280, 1600 / 8)
    "mapper_t25_hd128": (2, 2, 25, 25, 128, False, False, 0),
    "mapper_t25_hd160": (2, 2, 25, 25, 160, False, False, 0),
    "mapper_t25_hd200": (2, 2, 25, 25, 200, False, False, 0),
}


def _inputs(b, h, tq, tk, hd, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, tk, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, tk, hd)).astype(np.float32)
    w = rng.normal(size=(b, h, tq, hd)).astype(np.float32)  # weights of the scalar loss
    mask = None
    if masked:  # ragged key lengths; key 0 stays valid, so every row sees a key
        lens = rng.integers(1, tk + 1, size=b)
        mask = (np.arange(tk)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, w, mask


def _jax(q, k, v, w, mask, causal, q_offset):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        out = JA.flash_attention(q, k, v, causal=causal, key_mask=jm, q_offset=q_offset,
                                 interpret=True)
        return jnp.sum(out * w), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(q, k, v, w, mask, causal, q_offset):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = TA.flash_attention(tq, tk, tv, causal=causal, key_mask=tm, q_offset=q_offset)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax(case):
    b, h, tq, tk, hd, causal, masked, q_offset = CASES[case]
    q, k, v, w, mask = _inputs(b, h, tq, tk, hd, masked)
    want, want_grads = _jax(q, k, v, w, mask, causal, q_offset)
    got, got_grads = _torch(q, k, v, w, mask, causal, q_offset)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    tm = None if mask is None else torch.from_numpy(mask)
    twin = TA._flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), tm, causal, q_offset)
    np.testing.assert_allclose(twin.numpy(), want, atol=1e-5, rtol=1e-5)
    for name, g, gw in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, gw, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_fully_masked_row():
    """A batch row whose keys are all masked: the port's forward gives what
    the JAX package gives there, the uniform softmax over the Tk keys (the
    mean of v), which ``attention_xla`` computes and the Pallas kernel too
    where Tk fills its key block (8 <= Tk <= 128).  The backward is the
    reference's uniform softmax as well, so the gradients match everywhere."""
    q, k, v, w, _ = _inputs(2, 2, 12, 12, 8, False, seed=3)
    mask = np.ones((2, 12), np.int32)
    mask[0] = 0
    want, want_grads = _jax(q, k, v, w, mask, False, 0)
    got, got_grads = _torch(q, k, v, w, mask, False, 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True),
                                                       got[0].shape), atol=1e-5)
    xla = JNN.attention_xla(*(jnp.asarray(a) for a in (q, k, v)), key_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=1e-5)
    for name, g, gw in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, gw, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")
    assert np.abs(got_grads[2][0]).max() > 0  # the uniform softmax sends v a gradient


@pytest.mark.parametrize("causal", [True, False])
def test_mha_on_cpu_matches_jax(causal):
    """On the CPU the port's ``mha`` runs ``attention_xla``, as the JAX
    package's ``mha`` does off the TPU."""
    q, k, v, _, mask = _inputs(2, 4, 9, 9, 8, True, seed=1)
    want = JA.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  key_mask=jnp.asarray(mask))
    got = TA.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                 key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.mha(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, use_kernel=True)


def test_flash_attention_cuda_refuses_what_it_does_not_take():
    """The CUDA wrapper refuses CPU tensors before it touches the build; the
    dispatcher never hands them to it."""
    x = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TA.flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.flash_attention(x, x, x, use_kernel=True)
    assert TA.HEAD_DIMS == (64, 96, 128, 160, 208)
    assert TA.PADDED_HEAD_DIMS == {200: 208}


@pytest.mark.parametrize("hd", [64, 96, 128, 160, 200])
def test_padded_head_dim_keeps_the_true_scale(hd):
    """What the kernel is given at a head dim: 200 (GPT-2 XL's mapper) is
    zero-padded to the 208 build with the scale of 200, the others pass as
    they are.  The twin on the padded rows at that scale, cut back to hd,
    equals the JAX kernel (interpret mode) at hd; at the padded dim's own
    scale it would not."""
    q, k, v, w, mask = _inputs(2, 8, 25, 25, hd, True, seed=4)
    want, _ = _jax(q, k, v, w, mask, False, 0)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    pq, pk, pv, scale_hd = TA.pad_heads(tq, tk, tv)
    built = TA.PADDED_HEAD_DIMS.get(hd, hd)
    assert scale_hd == hd and pq.shape[-1] == built and built in TA.HEAD_DIMS
    assert all(torch.equal(p[..., :hd], t) for p, t in ((pq, tq), (pk, tk), (pv, tv)))
    assert all(not p[..., hd:].any() for p in (pq, pk, pv))
    got = TA._flash_attention_plain(pq, pk, pv, tm, scale_hd=scale_hd)[..., :hd]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if built != hd:
        wrong = TA._flash_attention_plain(pq, pk, pv, tm)[..., :hd]
        assert np.abs(wrong.numpy() - want).max() > 1e-3


# (Tq, Tk, hd) the kernel runs at: the paths' FLASH_SHAPES in chip_smoke.py
# (training, mapper, int8 prefill, CLIP, ViT, DINOv3), the card's extra
# contract cases (a causal tail with q_offset, hd 96 at T 197, T 1,024) and
# the tiny float32 models' 7 + 12 positions.
# Tq of the paths' shapes (training 65, the mapper 25, the prefill 15, the
# towers 50, 197 and 201), the long case 1,024 and a few short ones
PLAN_TQ = [65, 25, 15, 50, 197, 201, 1024, 19, 7, 1]


@pytest.mark.parametrize("tq", PLAN_TQ)
def test_flash_plan_covers_every_row(tq):
    """The q-tile split of ``csrc/flash_attention.cu``: its q-tiles cover
    every query row with none empty, each block holds 1-8 warps of 16 rows
    and computes fewer than 16 rows past Tq beyond its idle warps, and K and
    V are read at most twice a head at T <= 256."""
    plan = TA.flash_plan(tq)
    rows, tiles = plan.rows, plan.q_tiles
    assert plan.warps * 16 == rows and 1 <= plan.warps <= TA.FLASH_MAX_WARPS
    assert (tiles - 1) * rows < tq <= tiles * rows, plan
    tail = tq - (tiles - 1) * rows
    assert -(-tail // 16) * 16 - tail < 16
    assert tiles <= (2 if tq <= 256 else -(-tq // 128))
    if tq == 197:
        assert rows == 112
