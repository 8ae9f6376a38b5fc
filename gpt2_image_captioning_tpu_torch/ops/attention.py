"""Flash attention and the attention dispatcher — the counterpart of
``gpt2_image_captioning_tpu/ops/attention.py``.

Kernel: ``csrc/flash_attention.cu`` (hand-written CUDA for sm_90a; its
header comment gives the design and the bound), the port of the JAX
package's Pallas ``_flash_kernel``, wrapped by :func:`flash_attention_cuda`.
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
FLASH_MAX_WARPS = 8  # csrc/flash_attention.cu MAX_WARPS: a block's warps, 16 query rows each


class FlashPlan(NamedTuple):
    q_tiles: int  # blocks a (batch row, head)
    warps: int    # 16 query rows each
    rows: int     # query rows a block owns


@functools.cache
def flash_plan(tq: int) -> FlashPlan:
    """The flash kernel's split of Tq query rows: ``q_tiles`` blocks a
    (batch row, head), each of ``warps`` warps owning 16 rows, the q-tiles
    as even as 16-row granularity allows (Tq 197: 2 of 112 rows, where fixed
    128-row tiles would leave 59 idle rows), so K and V are read ``q_tiles``
    times a head.  The kernel sizes its K/V ring and shared memory from Tk
    and hd itself."""
    q_tiles = -(-tq // (16 * FLASH_MAX_WARPS))
    warps = -(-(-(-tq // q_tiles)) // 16)
    return FlashPlan(q_tiles, warps, 16 * warps)


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
    """Plain twin of ``csrc/flash_attention.cu``: float32 scores scaled by
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
    """Launch ``csrc/flash_attention.cu``.  q: (B, H, Tq, hd), k/v: (B, H, Tk,
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
        flash_plan(tq).warps, _build.stream_of(q),
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
