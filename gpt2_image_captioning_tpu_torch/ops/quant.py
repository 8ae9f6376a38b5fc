"""Symmetric int8 quantization for the W8A8 decode step and the int8 KV
cache — the counterpart of the int8 pieces of
``gpt2_image_captioning_tpu/ops/decode_step.py``.

- :func:`colquant`: weights per output column (``_colquant``, :882-887),
  once, when :func:`ops.decode_step.pack_decode_weights` packs ``quant=True``;
- :func:`rowquant_plain`: activations per row (the step kernel's
  ``rowquant``, :234-240), after the LayerNorm and the cast to the compute
  dtype where the step has one; the plain twin of ``csrc/rowquant.cu``
  (:func:`rowquant_cuda`);
- :func:`quantize_cache`: the caches after prefill (:951-968);
- :func:`int8_matmul`: the int8 tile of ``csrc/common.cuh`` — exact integer
  products, dequantized as ``acc * sx * sw``.

Every scale is ``max(max|x| * float32(1/127), 1e-12)`` in float32 and every
quantized value ``round(x / s)``, true division and half to even
(``torch.round``, ``jnp.round`` and CUDA's ``rintf`` all round so).
"""

from __future__ import annotations

import torch

from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops import nn

_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)  # float32(1/127), as jnp has it
MIN_SCALE = 1e-12


def absmax_quant(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values of ``x`` and their float32 scales over ``dim`` (kept as a
    size-1 dimension)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=dim, keepdim=True) * _INV127.to(xf.device), min=MIN_SCALE)
    return torch.round(xf / s).to(torch.int8), s


def colquant(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column quantization of ``(..., in, out)`` weights: int8 of
    the same shape and ``(..., out)`` float32 scales."""
    q, s = absmax_quant(w, dim=-2)
    return q, s.squeeze(-2)


def dequant(q: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of int8 ``q`` (..., D) times their scales ``s`` (...), computed in
    ``dtype`` as the TPU kernel does (``q.astype(cdt) * s.astype(cdt)``)."""
    return q.to(dtype) * s[..., None].to(dtype)


def quantize_cache(k: torch.Tensor, v: torch.Tensor):
    """(L, T, B, D) float caches → (int8 k, int8 v, k scales (L, T, B),
    v scales (L, T, B)) float32, every row quantized over its D; all-zero rows
    become int8 zeros with scale 1e-12."""
    kq, ks = absmax_quant(k)
    vq, vs = absmax_quant(v)
    return kq, vq, ks[..., 0], vs[..., 0]


def rowquant_plain(x: torch.Tensor, ln=None, eps: float = 1e-5, compute_dtype=None):
    """Plain twin of ``csrc/rowquant.cu``: (M, K) rows → (int8 (M, K), sx
    (M, 1) float32).  With ``ln=(scale, bias)`` the rows are the float32
    residual stream, LayerNorm'd and rounded to ``compute_dtype`` first."""
    if ln is not None:
        x = nn.layer_norm_rows(ln[0], ln[1], x.float(), eps).to(compute_dtype)
    return absmax_quant(x)


def rowquant_cuda(x: torch.Tensor, ln=None, eps: float = 1e-5, compute_dtype=None):
    """Launch ``csrc/rowquant.cu`` on contiguous (M, K) rows: float32 with
    ``ln=(scale, bias)`` (each (K,) float32), else ``compute_dtype`` (default
    ``x.dtype``).  Returns :func:`rowquant_plain`'s outputs.  ``launches``
    counts every launch of the quantizer kernel, the ones the int8 modes of
    the step's other wrappers make inside their calls included."""
    name = "rowquant"
    cdt = compute_dtype or x.dtype
    _build.require(x.is_cuda and x.is_contiguous() and x.dim() == 2, name,
                   "x must be a contiguous (M, K) CUDA tensor")
    _build.require(cdt in _build.DTYPE_CODE, name, f"unsupported compute dtype {cdt}")
    _build.require(x.dtype == (torch.float32 if ln is not None else cdt), name,
                   "x must be float32 with the LN, else the compute dtype")
    m, k = x.shape
    ln_s = ln_b = None
    if ln is not None:
        for t in ln:
            _build.require(t.shape == (k,) and t.dtype == torch.float32 and t.is_contiguous()
                           and t.device == x.device, name,
                           "LN scale/bias must be contiguous float32 (K,) on x's device")
        ln_s, ln_b = ln[0].data_ptr(), ln[1].data_ptr()
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = _build.library().gic_rowquant(
        _build.DTYPE_CODE[cdt], int(ln is not None), x.data_ptr(), ln_s, ln_b, eps, q.data_ptr(),
        sx.data_ptr(), m, k, _build.stream_of(x),
    )
    _build.check(err, name)
    rowquant_cuda.launches += 1
    return q, sx


rowquant_cuda.launches = 0


def int8_matmul(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                sw: torch.Tensor) -> torch.Tensor:
    """Twin of the int8 tile: int8 rows ``xq`` (M, K) with scales ``sx``
    (M, 1) times int8 weights ``wq`` (N, K) with per-row scales ``sw`` (N,) →
    (M, N) float32 ``float(acc) * sx * sw``.  The integer sums are exact, as
    the kernel's int32 accumulators are: int64 on the CPU, float64 on the card
    (|acc| <= K * 127^2 < 2^53); float32 would round them past K ~ 1,040."""
    if xq.is_cuda:
        acc = torch.mm(xq.double(), wq.double().t())
    else:
        acc = torch.mm(xq.long(), wq.long().t())
    return acc.float() * sx * sw
