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


# Tq of the paths' shapes (training 65, the mapper 25, the prefill 15, the
# towers 50, 197 and 201), the long case 1,024, a few short ones, and the
# prefixes past the prefill kernel's 32 tokens that prefill through
# forward_cached (33, 40, 64)
PLAN_TQ = [65, 25, 15, 50, 197, 201, 1024, 19, 7, 1, 33, 40, 64]


@pytest.mark.parametrize("tq", PLAN_TQ)
def test_flash_plan_covers_every_row(tq):
    """The work items of ``csrc/flash_attention.cuh``: 64-row items (one
    consumer warpgroup's wgmma M) cover every query row with none empty, so
    a block computes fewer than 64 rows past Tq in a head; K and V are read
    once an item."""
    plan = TA.flash_plan(tq)
    assert plan.rows == TA.FLASH_ROWS == 64
    assert (plan.q_tiles - 1) * plan.rows < tq <= plan.q_tiles * plan.rows, plan
    if tq <= 64:  # the short heads (the mapper, the prefill, a long prefix) are one item
        assert plan.q_tiles == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", TA.HEAD_DIMS)
def test_flash_layout_fits_shared_memory(dtype, hd):
    """Every instantiation's shared memory (``flash_layout``, the mirror of
    the kernel's ``Cfg``, which ``chip_smoke.py`` holds to the C side) fits an
    H100 block's 227 KB; its slabs are whole 64-byte swizzled rows (a bf16
    head dim rounds up to 32 elements, float32's to 16) and 1024-byte
    multiples; float32 adds the TF32 lo halves and V^T over the output
    columns rounded up to 32."""
    lay = TA.flash_layout(dtype, hd)
    assert lay.smem_bytes <= TA.SMEM_LIMIT, lay
    el = 4 if dtype == torch.float32 else 2
    chunk = TA.FLASH_ROW_BYTES // el
    row = -(-hd // chunk) * TA.FLASH_ROW_BYTES  # bytes of a row in shared memory
    assert row >= hd * el and row - hd * el < TA.FLASH_ROW_BYTES
    q_bytes = TA.FLASH_ROWS * row * (2 if el == 4 else 1)
    hdv = -(-hd // TA.FLASH_PV_COLUMNS) * TA.FLASH_PV_COLUMNS
    stage = 2 * lay.kv_tile * row + (2 * hdv * lay.kv_tile * 4 if el == 4 else 0)
    assert lay.smem_bytes == 1024 + lay.q_buffers * q_bytes + lay.stages * stage
    assert all(x % 1024 == 0 for x in (q_bytes, stage, lay.kv_tile * row))
    assert lay.kv_tile in (32, 64) and lay.stages >= 1 and lay.q_buffers in (1, 2)
    assert lay.threads == (288 if el == 4 else 256)


def _tf32(x):
    """``cvt.rna.tf32.f32`` / ``common.cuh::tf32_rna_bits``: to nearest,
    ties away from zero, on the float32 bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32x3(a, b):
    """a @ b as the kernel's three TF32 products (al bh + ah bl + ah bh),
    each exact in float64, the sum rounded to float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d) + ah.to(d) @ bh.to(d)).float()


def _p_as_register_a(p):
    """The (64, BKV) matrix the tensor core reads from P's registers in the
    float32 route: thread (warp w, g = lane / 4, t = lane % 4) holds S's
    accumulators d[4j + e] = P[16 w + g + 8 (e // 2), 8 j + 2 t + e % 2];
    the kernel passes d[4s], d[4s + 2], d[4s + 1], d[4s + 3] as k8 step s's
    registers a0..a3, which wgmma's TF32 A layout reads as (16 w + g, t),
    (16 w + g + 8, t), (16 w + g, t + 4) and (16 w + g + 8, t + 4)."""
    a = torch.full_like(p, float("nan"))
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            r0, r1 = 16 * w + g, 16 * w + g + 8
            for s in range(p.shape[1] // 8):
                d = {4 * s + e: p[r0 if e < 2 else r1, 8 * s + 2 * t + e % 2] for e in range(4)}
                a[r0, 8 * s + t], a[r1, 8 * s + t] = d[4 * s], d[4 * s + 2]
                a[r0, 8 * s + t + 4], a[r1, 8 * s + t + 4] = d[4 * s + 1], d[4 * s + 3]
    return a


def _v_transposed(v, hdv):
    """V^T as the float32 converters write it (``transpose_v``): row n (an
    output column, hdv rows, those past hd zero), key j of each 16-key chunk
    at position 8 (j // 8) + (j % 8) // 2 + 4 (j % 2)."""
    bkv, hd = v.shape
    vt = torch.zeros(hdv, bkv, dtype=v.dtype)
    for key in range(bkv):
        j = key % 16
        vt[:hd, 16 * (key // 16) + 8 * (j // 8) + (j % 8) // 2 + 4 * (j % 2)] = v[key]
    return vt


def _flash_f32_route(q, k, v, causal, scale_hd):
    """One head (T, hd) through the float32 route's operand order: the
    kernel's key tiles, S from the TF32 split of Q and K, the online softmax,
    P V from P's registers (read in the permuted key order) against V^T
    (the same order), a fresh accumulator a tile folded in as O alpha + PV."""
    tq, hd = q.shape
    tk = k.shape[0]
    lay = TA.flash_layout(torch.float32, hd)
    bkv, hdv = lay.kv_tile, -(-hd // TA.FLASH_PV_COLUMNS) * TA.FLASH_PV_COLUMNS
    log2e = 1.4426950408889634
    scale = torch.tensor(log2e / np.sqrt(scale_hd), dtype=torch.float32)
    out = torch.zeros(tq, hd)
    for q0 in range(0, tq, 64):
        qt = torch.zeros(64, hd)
        qt[: min(64, tq - q0)] = q[q0 : q0 + 64]
        o = torch.zeros(64, hdv)
        m = torch.full((64, 1), -float("inf"))
        l_ = torch.zeros(64, 1)
        rows = torch.arange(q0, q0 + 64)[:, None]
        for k0 in range(0, tk, bkv):
            kt, vt = torch.zeros(bkv, hd), torch.zeros(bkv, hd)  # TMA's zero fill past Tk
            kt[: min(bkv, tk - k0)] = k[k0 : k0 + bkv]
            vt[: min(bkv, tk - k0)] = v[k0 : k0 + bkv]
            keys = torch.arange(k0, k0 + bkv)[None, :]
            ok = (keys < tk) & ((keys <= rows) if causal else True)
            s = torch.where(ok, _tf32x3(qt, kt.T) * scale, -float("inf"))
            m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
            alpha = torch.where(m_new == -float("inf"), 1.0, torch.exp2(m - m_new))
            p = torch.where(s == -float("inf"), 0.0, torch.exp2(s - m_new))
            l_ = l_ * alpha + p.sum(dim=1, keepdim=True)
            m = m_new
            o = o * alpha + _tf32x3(_p_as_register_a(p), _v_transposed(vt, hdv).T)
        out[q0 : q0 + 64] = (o[:, :hd] / l_)[: min(64, tq - q0)]
    return out


@pytest.mark.parametrize("tq, hd, causal, real_hd", [
    (25, 96, False, 96),     # the float32 mapper's heads
    (40, 64, True, 64),      # a long prefix through forward_cached
    (25, 208, False, 200),   # GPT-2 XL's mapper, zero-padded to the 208 build
    (70, 128, True, 128),    # two items a head, three key tiles
])
def test_flash_f32_operand_order_matches_twin(tq, hd, causal, real_hd):
    """A CPU model of the float32 route's operand order: P V read from P's
    accumulator registers as wgmma's TF32 A fragments (the keys of each k8
    step in the order 0, 2, 4, 6, 1, 3, 5, 7) against V^T written in that
    order, with Q, K, P and V split into TF32 hi and lo, agrees with
    ``_flash_attention_plain`` within chip_smoke.py's float32 FLASH_TOL
    (1e-5)."""
    rng = np.random.default_rng(hd + tq)
    q, k, v = (torch.from_numpy(rng.normal(size=(tq, real_hd)).astype(np.float32))
               for _ in range(3))
    pq, pk, pv, scale_hd = TA.pad_heads(*(x[None, None] for x in (q, k, v)))
    assert pq.shape[-1] == hd and scale_hd == real_hd
    got = _flash_f32_route(pq[0, 0], pk[0, 0], pv[0, 0], causal, scale_hd)[:, :real_hd]
    want = TA._flash_attention_plain(q[None, None], k[None, None], v[None, None],
                                     causal=causal)[0, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
    # the permutations cancel: P's registers against V^T give P V, while V^T
    # in the plain key order would pair P with the wrong keys of V
    p, vv = torch.rand(64, 32, dtype=torch.float64), torch.rand(32, 16, dtype=torch.float64)
    np.testing.assert_allclose(_p_as_register_a(p) @ _v_transposed(vv, 32).T[:, :16],
                               p @ vv, rtol=1e-12)
    assert not torch.allclose(_p_as_register_a(p) @ vv, p @ vv)
