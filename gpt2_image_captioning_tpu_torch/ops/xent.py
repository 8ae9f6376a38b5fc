"""Vocab-chunked softmax cross-entropy — the counterpart of
``gpt2_image_captioning_tpu/ops/xent.py``.

The teacher-forcing loss is dominated by the tied-embedding logits, (N,
50257) float32 for N caption positions.  :class:`XentSum` walks the
vocabulary in column chunks and never holds the whole logits tensor:

  forward : per chunk  logits_c = h @ wte_cᵀ → online logsumexp; the gold
            logit accumulates through a ``col == label`` mask (no gather).
  backward: per chunk  p_c = exp(logits_c − logz); p_c[label] −= 1;
            dh += p_c @ wte_c; dwte_c = p_cᵀ @ h (no scatter).

The chunk products are plain matrix products (:func:`ops.nn.dot_f32`, float32
accumulation), as the JAX package leaves them to XLA outside any Pallas
kernel.  ``dwte`` is computed only when ``wte`` needs a gradient: with a
frozen decoder the JAX package relies on dead-code elimination there, and
eager PyTorch would otherwise run those products and discard them.
:func:`models.gpt2.cross_entropy_loss` is the oracle.
"""

from __future__ import annotations

import torch

from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.nn import NEG_INF

IGNORE_INDEX = -100
DEFAULT_CHUNK = 2048  # the JAX package's choice (its on-chip sweep)


def _chunk_logits(h, wte, off: int, chunk: int) -> torch.Tensor:
    """(N, c) float32 logits of vocabulary columns [off, off + c)."""
    return nn.dot_f32(h, wte[off : off + chunk].to(h.dtype).t())


class XentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wte, labels, chunk: int):
        n = h.shape[0]
        valid = labels != IGNORE_INDEX
        safe = torch.where(valid, labels, 0)
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        gold = torch.zeros((n,), dtype=torch.float32, device=h.device)
        for off in range(0, wte.shape[0], chunk):
            logits = _chunk_logits(h, wte, off, chunk)
            col = off + torch.arange(logits.shape[1], device=h.device)[None, :]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            gold = gold + torch.where(col == safe[:, None], logits, 0.0).sum(dim=-1)
            m = m_new
        logz = m + torch.log(s)
        ctx.save_for_backward(h, wte, labels, logz)
        ctx.chunk = chunk
        return ((logz - gold) * valid).sum()

    @staticmethod
    def backward(ctx, g):
        h, wte, labels, logz = ctx.saved_tensors
        chunk = ctx.chunk
        valid = (labels != IGNORE_INDEX).float()
        safe = torch.where(labels != IGNORE_INDEX, labels, 0)
        want_dwte = ctx.needs_input_grad[1]
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw_chunks = []
        for off in range(0, wte.shape[0], chunk):
            logits = _chunk_logits(h, wte, off, chunk)
            col = off + torch.arange(logits.shape[1], device=h.device)[None, :]
            p = torch.exp(logits - logz[:, None]) - (col == safe[:, None]).float()
            p_c = (p * (valid[:, None] * g)).to(h.dtype)  # dL/dlogits of this chunk
            w_c = wte[off : off + chunk].to(h.dtype)
            dh += nn.dot_f32(p_c, w_c)
            if want_dwte:
                dw_chunks.append(nn.dot_f32(p_c.t(), h))
        dwte = torch.cat(dw_chunks).to(wte.dtype) if want_dwte else None
        return dh.to(h.dtype), dwte, None, None


def xent_sum(h: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
             chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Σ NLL of ``labels`` under ``softmax(h @ wteᵀ)`` with -100 ignored, a
    float32 scalar.  h: (N, D) compute dtype; wte: (V, D); labels: (N,) int.
    The valid-token count (for the mean) is ``(labels != -100).sum()``."""
    return XentSum.apply(h, wte, labels, chunk)
