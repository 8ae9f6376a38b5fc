"""Single-token decode attention over the valid KV-cache prefix, fused with
the cache append — the counterpart of ``gpt2_image_captioning_tpu/ops/decode_attention.py``.

The cache layout is the JAX package's (T, B, D): D = n_head·head_dim, so the
QKV projection's rows append with no head split.  :func:`decode_attention`
writes this step's K/V rows at ``idx`` (in place: PyTorch tensors are
mutable, which saves a cache copy per layer and step) and attends rows
``[0, idx]``.  Beam search passes an ancestry map ``origin`` (T, B) int32:
row r then reads position t in ``[gather_start, idx)`` from cache row
``origin[t, r]`` (the JAX step kernel's beam mode), so the caches are never
gathered or rewritten between steps.  Continuous batching passes a (B,)
int32 ``start`` instead: row r then attends only ``[start_r, idx]`` (the JAX
step kernel's ``start``; a row with ``start_r == idx`` is dead and attends
its own new row alone).  int8 caches come with (T, B) float32 per-row scales
``k_scale``/``v_scale`` (the JAX step kernel's int8 cache): the new rows are
quantized over their whole D in the same launch (the row quantizer's
formula, ``ops/quant.py::absmax_quant``), and the walk dequantizes each row
in the compute dtype; the new row's own term uses the exact
``k_new``/``v_new``.

Kernel: ``csrc/decode_attention.cu`` (hand-written CUDA for sm_90a; its
header comment gives the design and the bound), wrapped by
:func:`decode_attention_cuda`.  Plain twin: :func:`_decode_attention_plain`,
the JAX package's ``_decode_attention_xla`` formula, which the CPU runs and
the card holds the kernel to.
"""

from __future__ import annotations

import math

import torch

from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops.nn import NEG_INF
from gpt2_image_captioning_tpu_torch.ops.quant import absmax_quant, dequant

# init_cache rounds the cache length up to a multiple of this (the JAX
# package's chunk; the kernel walks any length).
CHUNK_T = 16


def _decode_attention_plain(q, k_new, v_new, k_cache, v_cache, idx: int, n_head: int,
                            origin=None, gather_start: int = 0, start=None, k_scale=None,
                            v_scale=None):
    """Append at ``idx``, then float32 attention of each row's query over cache
    rows ``[0, idx]``; rows past ``idx`` are masked.  With ``origin``, the
    positions ``[gather_start, idx)`` are first gathered from the rows it
    names; position ``idx`` is each row's own new row.  With ``start``,
    row r's positions below ``start[r]`` are masked too.  With scales, the
    int8 append and the dequantized walk, the own row exact.  The scores,
    the softmax and p·v run in float64, rounded once to float32 and then to
    q's dtype, as the kernel computes them: both then round the exact
    result on the same inputs, whatever the order of their sums."""
    tk, b, d = k_cache.shape
    if k_scale is None:
        k_cache[idx] = k_new.to(k_cache.dtype)
        v_cache[idx] = v_new.to(v_cache.dtype)
        kc, vc = k_cache, v_cache
    else:
        for new, cache, scale in ((k_new, k_cache, k_scale), (v_new, v_cache, v_scale)):
            cache[idx], s = absmax_quant(new)
            scale[idx] = s[:, 0]
        kc, vc = (dequant(c, s, q.dtype) for c, s in ((k_cache, k_scale), (v_cache, v_scale)))
        kc[idx], vc[idx] = k_new, v_new
    if origin is not None:
        src = torch.arange(b, device=q.device).expand(tk, b).clone()
        src[gather_start:idx] = origin[gather_start:idx].long()
        kc, vc = (c.gather(1, src[:, :, None].expand(tk, b, d)) for c in (kc, vc))
    hd = d // n_head
    scale = 1.0 / math.sqrt(hd)
    qh = q.reshape(b, n_head, hd).double()
    kh = kc.reshape(tk, b, n_head, hd).double()
    vh = vc.reshape(tk, b, n_head, hd).double()
    s = torch.einsum("bhd,kbhd->bhk", qh, kh) * scale
    pos = torch.arange(tk, device=q.device)
    live = (pos <= idx)[None, None, :]
    if start is not None:
        live = live & (pos[None, :] >= start.to(pos.dtype)[:, None])[:, None, :]
    p = torch.softmax(torch.where(live, s, NEG_INF), dim=-1)
    out = torch.einsum("bhk,kbhd->bhd", p, vh)
    return out.reshape(b, d).float().to(q.dtype)


def decode_attention_cuda(q, k_new, v_new, k_cache, v_cache, idx: int, n_head: int,
                          origin=None, gather_start: int = 0, start=None, k_scale=None,
                          v_scale=None):
    """Launch ``csrc/decode_attention.cu`` (one CUDA launch, the int8
    append included).  q/k_new/v_new (B, D) may be column slices of one
    (B, 3D) QKV tensor (equal row strides, unit column stride); caches (T, B,
    D) contiguous, in q's dtype, or int8 with k_scale/v_scale (T, B) float32
    contiguous; origin (T, B) int32 contiguous with entries in [0, B), or
    None; start (B,) int32 contiguous with entries in [0, idx], or None;
    returns (B, D).  ``launches`` counts every call, ``start_launches`` those
    with a start window."""
    name = "decode_attention"
    _build.require(q.is_cuda, name, "q must be a CUDA tensor")
    # plain and-chains, not generators: the host's enqueue sets the rate of
    # a kernel this short
    dtype, device, shape, strides = q.dtype, q.device, q.shape, q.stride()
    b, d = shape
    tk = k_cache.shape[0]
    _build.require(
        dtype in _build.DTYPE_CODE and strides[1] == 1
        and k_new.shape == shape and v_new.shape == shape
        and k_new.stride() == strides and v_new.stride() == strides
        and k_new.dtype == dtype and v_new.dtype == dtype
        and k_new.device == device and v_new.device == device, name,
        "q, k_new and v_new must share dtype, device, their (B, D) shape and one row stride "
        "with unit column stride, in float32 or bfloat16")
    cache_shape = (tk, b, d)
    _build.require(
        k_cache.dtype == v_cache.dtype == (dtype if k_scale is None else torch.int8)
        and k_cache.shape == cache_shape and v_cache.shape == cache_shape
        and k_cache.device == device and v_cache.device == device
        and k_cache.is_contiguous() and v_cache.is_contiguous(), name,
        "caches must be contiguous (T, B, D), int8 with scales, else in q's dtype, on q's device")
    if k_scale is not None:
        _build.require(
            v_scale is not None and k_scale.shape == v_scale.shape == (tk, b)
            and k_scale.dtype == v_scale.dtype == torch.float32
            and k_scale.device == device and v_scale.device == device
            and k_scale.is_contiguous() and v_scale.is_contiguous(), name,
            "k_scale and v_scale must be contiguous float32 (T, B) on q's device")
    _build.require(d % n_head == 0 and d // n_head <= 128 and 0 <= idx < tk, name,
                   "head_dim must divide D and be <= 128, and idx must lie inside the cache")
    if origin is not None:
        _build.require(origin.shape == (tk, b) and origin.dtype == torch.int32
                       and origin.is_contiguous() and origin.device == device
                       and gather_start >= 0, name,
                       "origin must be a contiguous int32 (T, B) tensor on q's device, "
                       "gather_start >= 0")
    if start is not None:
        _build.require(origin is None and start.shape == (b,) and start.dtype == torch.int32
                       and start.is_contiguous() and start.device == device, name,
                       "start must be a contiguous int32 (B,) tensor on q's device, "
                       "exclusive with origin")
    out = q.new_empty((b, d))
    err = _build.library().gic_decode_attention(
        _build.DTYPE_CODE[dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        strides[0], k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        b, d, n_head, idx, _build.ptr(origin), int(gather_start), _build.ptr(start),
        _build.ptr(k_scale), _build.ptr(v_scale), _build.stream_of(q),
    )
    _build.check(err, name)
    decode_attention_cuda.launches += 1
    if start is not None:
        decode_attention_cuda.start_launches += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.start_launches = 0


def decode_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    idx: int,
    *,
    n_head: int,
    origin: torch.Tensor | None = None,
    gather_start: int = 0,
    start: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step of attention, fused with the cache append.

    q/k_new/v_new: (B, D) this step's projections; k_cache/v_cache: (T, B, D)
    with rows ``[0, idx)`` valid; ``idx``: host int, the write position;
    ``origin``: the (T, B) int32 ancestry map read for positions
    ``[gather_start, idx)``, or None; ``start``: each row's first live
    position (B,) int32, or None for 0 — exclusive with ``origin``;
    ``k_scale``/``v_scale``: the (T, B) float32 row scales of int8 caches,
    whose row ``idx`` is written in place.  Returns ``(attn_out (B, D),
    k_cache, v_cache)``; the caches are the argument tensors, updated in
    place.  ``use_kernel`` as in
    :func:`ops._build.kernels_enabled`.
    """
    if start is not None and origin is not None:
        raise ValueError("start and origin are exclusive (beam search never passes a start)")
    idx = int(idx)
    fn = (decode_attention_cuda if _build.kernels_enabled(use_kernel, q.device)
          else _decode_attention_plain)
    if (k_cache.dtype == torch.int8) != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 caches need k_scale and v_scale, and only they take them")
    out = fn(q, k_new, v_new, k_cache, v_cache, idx, n_head, origin, int(gather_start), start,
             k_scale, v_scale)
    return out, k_cache, v_cache
