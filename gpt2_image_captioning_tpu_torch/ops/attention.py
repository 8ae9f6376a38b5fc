"""Flash attention and the attention dispatcher — the counterpart of
``gpt2_image_captioning_tpu/ops/attention.py``.

Kernel: ``csrc/flash_attention.cuh`` (hand-written CUDA for sm_90a: TMA
loads, both products on ``wgmma``; its header comment gives the design and
the bound; ``flash_attention.cu`` holds the C entry), the port of the JAX
package's Pallas ``_flash_kernel``, wrapped by :func:`flash_attention_cuda`;
:func:`flash_plan` and :func:`flash_layout` mirror its work split and its
shared memory.
Plain twin: :func:`_flash_attention_plain`, which follows the kernel's own
math (float32 scores and softmax, p·v in float32) rather than
:func:`ops.nn.attention_xla`'s.  A row with no valid key takes the uniform
softmax over the Tk keys, the mean of v, as ``attention_xla`` and the JAX
package give there.

:class:`FlashAttention` carries the gradient: its forward is the kernel (or
the twin, for CPU tensors), its backward the recompute formula of the JAX
package's ``_flash_bwd`` in torch ops.  :func:`mha` dispatches as the JAX
package's ``mha`` does, except that on the card the flash kernel is the
default: CUDA tensors run the kernel; ``use_kernel=False`` and CPU tensors
run ``attention_xla``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.ops import _build, nn
from gpt2_image_captioning_tpu_torch.ops.nn import NEG_INF

# the head dims the kernel is built for: GPT-2 124M and the towers (64), the
# transformer mapper at GPT-2 124M / medium / large (96, 128, 160), and 208,
# to which the wrapper zero-pads GPT-2 XL's mapper heads of 200
HEAD_DIMS = (64, 96, 128, 160, 208)
PADDED_HEAD_DIMS = {200: 208}  # head dim served by zero-padding → the build it runs
FLASH_ROWS = 64  # csrc/flash_attention.cuh BM: query rows of a work item (one warpgroup's wgmma M)
FLASH_ROW_BYTES = 64  # a 64-byte swizzled row of shared memory: 32 bf16 or 16 floats of hd
FLASH_PV_COLUMNS = 32  # output columns of one P V product
SMEM_LIMIT = 232_448  # an H100 block's shared memory (227 KB)


class FlashPlan(NamedTuple):
    q_tiles: int  # work items a (batch row, head)
    rows: int     # query rows an item owns: one consumer warpgroup


class FlashLayout(NamedTuple):
    kv_tile: int    # keys a K/V tile of the ring
    stages: int     # ring stages
    q_buffers: int  # Q buffers (the producer loads the next item's Q into the other)
    threads: int    # the consumer warpgroup; the converters (float32) or the producer's warpgroup;
                    # float32's producer warp
    smem_bytes: int


@functools.cache
def flash_plan(tq: int) -> FlashPlan:
    """The flash kernel's split of Tq query rows: work items of 64 rows
    (one consumer warpgroup's wgmma tile), ``q_tiles`` of them a (batch row,
    head); every item reads its head's K and V through the ring.  The kernel
    walks the items in persistent blocks, so a head of fewer than 64 rows
    (the mapper's 25, the prefill's 15) is one item that overlaps the next
    one's loads."""
    return FlashPlan(-(-tq // FLASH_ROWS), FLASH_ROWS)


@functools.cache
def flash_layout(dtype: torch.dtype, hd: int) -> FlashLayout:
    """Mirror of ``csrc/flash_attention.cuh::Cfg``: a block's key tile, ring,
    Q buffers, threads and shared memory for one (dtype, built head dim).
    Shared memory holds 64-byte swizzled rows chunk-major (a bf16 head dim
    rounds up to 32 elements: 208 is read as 224); float32 doubles Q and K
    into their TF32 hi and lo and holds V^T hi and lo beside them, over the
    output columns rounded up to 32."""
    f32 = dtype == torch.float32
    el = 4 if f32 else 2
    chunks = -(-hd * el // FLASH_ROW_BYTES)
    hdv = -(-hd // FLASH_PV_COLUMNS) * FLASH_PV_COLUMNS
    kv_tile = 32 if f32 and hd > 64 else 64
    if f32:
        q_buffers, stages = (2 if hd <= 128 else 1), (2 if hd <= 96 else 1)
    else:
        q_buffers = 2 if hd <= 160 else 1
        stages = {64: 3, 96: 3, 128: 2}.get(hd, 1)
    q_slab = FLASH_ROWS * chunks * FLASH_ROW_BYTES
    kv_slab = kv_tile * chunks * FLASH_ROW_BYTES
    vt_slab = hdv * kv_tile * 4 if f32 else 0
    smem = 1024 + q_buffers * q_slab * (2 if f32 else 1) + stages * (2 * kv_slab + 2 * vt_slab)
    return FlashLayout(kv_tile, stages, q_buffers, 288 if f32 else 256, smem)


def _valid(q, k, key_mask, causal: bool, q_offset: int) -> torch.Tensor:
    """(B or 1, 1, Tq, Tk) bool: which (query, key) pairs may attend."""
    tq, tk = q.shape[2], k.shape[2]
    valid = torch.ones((1, 1, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        valid = valid & (torch.arange(tk, device=q.device)[None, :] <= qpos)
    if key_mask is not None:
        valid = valid & key_mask[:, None, None, :].bool()
    return valid


def pad_heads(q, k, v):
    """(q, k, v, scale_hd) as the kernel takes them: a head dim of
    :data:`PADDED_HEAD_DIMS` zero-padded to its build (new tensors), its own
    head dim kept for the 1/sqrt scale; any other head dim as it is."""
    hd = q.shape[-1]
    if hd not in PADDED_HEAD_DIMS:
        return q, k, v, hd
    pad = PADDED_HEAD_DIMS[hd] - hd
    return (*(F.pad(t, (0, pad)) for t in (q, k, v)), hd)


def _flash_attention_plain(q, k, v, key_mask=None, causal: bool = False, q_offset: int = 0,
                           scale_hd: int | None = None):
    """Plain twin of ``csrc/flash_attention.cuh``: float32 scores scaled by
    1/sqrt(scale_hd) (default: q's head dim), the masks, a float32 softmax,
    p·v in float32, the output cast to q's dtype; a row with no valid key
    gives the mean of v over the Tk keys (zeros when Tk is 0)."""
    scale = 1.0 / math.sqrt(scale_hd or q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    valid = _valid(q, k, key_mask, causal, q_offset)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.where(l == 0.0, 1.0, l)
    mean_v = v.float().sum(dim=2, keepdim=True) / max(k.shape[2], 1)
    return torch.where(l == 0.0, mean_v, out).to(q.dtype)


def _flash_backward(q, k, v, key_mask, causal: bool, q_offset: int, g):
    """The recompute-softmax backward of the JAX package's ``_flash_bwd``
    (:130-150), in float32, gradients cast to the input dtypes.  A row with
    no valid key takes the uniform softmax there, as in the reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    s = torch.where(_valid(q, k, key_mask, causal, q_offset), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_cuda(q, k, v, key_mask=None, causal: bool = False, q_offset: int = 0):
    """Launch ``csrc/flash_attention.cuh``.  q: (B, H, Tq, hd), k/v: (B, H, Tk,
    hd), one dtype (bf16 or float32), any strides with a unit stride on hd
    (the permuted views of ``nn.split_heads`` are read in place); hd one of
    :data:`HEAD_DIMS`, or 200, which is zero-padded to 208 (copies of q, k
    and v) and scaled by 1/sqrt(200); key_mask: (B, Tk), nonzero = attend, or
    None.  Returns (B, H, Tq, hd) as a view of a contiguous (B, Tq, H, hd)
    tensor (of (B, Tq, H, 208) for hd 200), the layout ``nn.merge_heads``
    reads without a copy."""
    name = "flash_attention"
    _build.require(q.is_cuda, name, "q must be a CUDA tensor")
    _build.require(q.dtype in _build.DTYPE_CODE, name, f"unsupported dtype {q.dtype}")
    b, h, tq, hd = q.shape
    tk = k.shape[2]
    _build.require(hd in HEAD_DIMS or hd in PADDED_HEAD_DIMS, name,
                   f"head_dim must be one of {HEAD_DIMS + tuple(PADDED_HEAD_DIMS)}, got {hd}")
    _build.require(k.shape == (b, h, tk, hd) and v.shape == k.shape, name,
                   "k and v must be (B, H, Tk, hd) with q's B, H and hd")
    q, k, v, scale_hd = pad_heads(q, k, v)
    hd = q.shape[-1]
    vec = 16 // q.element_size()
    for t in (q, k, v):
        _build.require(t.dtype == q.dtype and t.device == q.device, name,
                       "q, k and v must share dtype and device")
        _build.require(t.stride(3) == 1 and all(s % vec == 0 for s in t.stride()[:3])
                       and t.data_ptr() % 16 == 0, name,
                       "q, k, v need a unit stride on hd and 16-byte-aligned rows")
    mask_ptr = None
    if key_mask is not None:
        _build.require(tuple(key_mask.shape) == (b, tk) and key_mask.device == q.device, name,
                       "key_mask must be (B, Tk) on q's device")
        key_mask = key_mask.to(torch.int32).contiguous()
        mask_ptr = key_mask.data_ptr()
    out = torch.empty((b, tq, h, hd), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    if tq == 0:
        return out[..., :scale_hd]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    err = _build.library().gic_flash_attention(
        _build.DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        mask_ptr, b, h, tq, tk, hd, scale_hd, strides, int(causal), int(q_offset),
        flash_plan(tq).q_tiles, _build.stream_of(q),
    )
    _build.check(err, name)
    flash_attention_cuda.launches += 1
    return out[..., :scale_hd]


flash_attention_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the reference's gradient: the forward is the
    kernel (the twin for CPU tensors); the backward recomputes the softmax in
    torch ops (:func:`_flash_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal: bool, q_offset: int, use_kernel):
        if _build.kernels_enabled(use_kernel, q.device):
            out = flash_attention_cuda(q, k, v, key_mask, causal, q_offset)
        else:
            out = _flash_attention_plain(q, k, v, key_mask, causal, q_offset)
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, key_mask, ctx.causal, ctx.q_offset, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_mask: torch.Tensor | None = None,
    q_offset: int = 0,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Fused attention.  q: (B, H, Tq, hd), k/v: (B, H, Tk, hd), key_mask:
    (B, Tk) 1 = attend (None: every key); query i attends keys
    <= q_offset + i when ``causal``.  ``use_kernel`` as in
    :func:`ops._build.kernels_enabled`.  Differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, key_mask, causal, int(q_offset), use_kernel)


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_mask: torch.Tensor | None = None,
    q_offset: int = 0,
    policy: Policy | None = None,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """Attention dispatcher: CUDA tensors run the flash kernel (cast to the
    policy's compute dtype, as the JAX package's Pallas branch); with
    ``use_kernel=False``, and for CPU tensors, the plain
    :func:`ops.nn.attention_xla` — the JAX package's default on the CPU and
    the TPU.  ``use_kernel=True`` on CPU tensors raises."""
    policy = policy or F32
    if _build.kernels_enabled(use_kernel, q.device):
        out = flash_attention(q, k, v, causal=causal, key_mask=key_mask, q_offset=q_offset,
                              use_kernel=True)
        return out.to(policy.compute_dtype)
    return nn.attention_xla(
        q, k, v, causal=causal, key_mask=key_mask, q_offset=q_offset, policy=policy
    )
