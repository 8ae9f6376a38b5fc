"""Token selection for decoding — the counterpart of
``gpt2_image_captioning_tpu/ops/sampling.py``: temperature scaling, the top-p
(nucleus) mask, a small top-k, and the categorical draw.

These are XLA ops in the JAX package, not Pallas kernels, so here they are
torch ops.  The masks are the JAX package's exactly; the random draws are
not (``torch.Generator`` is not ``jax.random``), only their distribution is:
the categorical draw is Gumbel-max, the method ``jax.random.categorical``
uses, on uniforms from the caller's generator.
"""

from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus by sorting: keep the smallest set of
    tokens whose cumulative probability exceeds ``top_p`` (the first token
    crossing the threshold is kept).  logits: (B, V) float32.  A stable
    descending sort puts equal logits in index order, as ``lax.top_k``."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum_probs > top_p
    remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
    mask = torch.zeros_like(remove).scatter(-1, sorted_idx, remove)
    return torch.where(mask, NEG_INF, logits)


def top_p_filter_bisect(
    logits: torch.Tensor,
    top_p: float | torch.Tensor,
    iters: int = 32,
    ways: int = 2,
) -> torch.Tensor:
    """Sort-free nucleus mask: the kept set of :func:`top_p_filter`, found by
    a per-row bisection on the logit threshold.

    Token t is kept iff the probability mass of the tokens with a strictly
    larger logit is ≤ ``top_p``; that mass is a monotone step function of
    the logit, so ``iters`` halvings of the bracket [row_min − 1, row_max]
    isolate the smallest kept logit.  ``top_p`` is a float or a per-row
    (B, 1) tensor; rows with ``top_p >= 1`` keep every token.  ``ways`` > 2
    tests ``ways − 1`` thresholds per pass (⌈iters / log2(ways)⌉ passes).
    Each row always keeps its top-1, so the kept set is never empty.
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(logits - lse)
    hi = logits.amax(dim=-1, keepdim=True)
    lo = logits.amin(dim=-1, keepdim=True) - 1.0

    if ways == 2:
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            # compare in probability space, as the JAX package does: probs >
            # exp(mid - lse) is logits > mid up to one exp rounding
            thr = torch.exp(mid - lse)
            mass_above = torch.where(probs > thr, probs, 0.0).sum(dim=-1, keepdim=True)
            keep_mid = mass_above <= top_p  # the threshold is ≤ mid: lower hi, else raise lo
            lo, hi = torch.where(keep_mid, lo, mid), torch.where(keep_mid, mid, hi)
    else:
        k = ways - 1  # interior thresholds per pass
        passes = math.ceil(iters / math.log2(ways))
        frac = (torch.arange(1, k + 1, dtype=torch.float32, device=logits.device) / ways)[None, :]
        for _ in range(passes):
            mids = lo + (hi - lo) * frac  # (B, k), ascending
            thr = torch.exp(mids - lse)
            mass_above = torch.cat(
                [torch.where(probs > thr[:, i : i + 1], probs, 0.0).sum(dim=-1, keepdim=True)
                 for i in range(k)], dim=-1,
            )
            # the mass is non-increasing in the threshold, so the kept
            # thresholds are a suffix: the threshold lies in (pad[first], pad[first + 1]]
            nkeep = (mass_above <= top_p).sum(dim=-1, keepdim=True)
            first_keep = k - nkeep
            pad = torch.cat([lo, mids, hi], dim=-1)
            lo, hi = pad.gather(-1, first_keep), pad.gather(-1, first_keep + 1)
    # the loop compares in exp space, this mask in logit space; where the
    # nucleus is one token a one-ulp slip could land lo on the row max and
    # keep nothing, so the top-1 is kept explicitly, as the JAX package does
    top = logits.amax(dim=-1, keepdim=True)
    return torch.where((logits > lo) | (logits >= top), logits, NEG_INF)


def topk_small(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k by k rounds of argmax-and-mask: values descending, ties to the
    lowest index (``lax.top_k``'s order).  Taken entries are masked with
    ``-inf``, below every candidate, ``NEG_INF`` ones included (dead beams
    carry ``NEG_INF`` scores), so the k indices are distinct.
    x: (..., n) float; returns ((..., k) values, (..., k) int32 indices)."""
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)  # the first index of the max
        vals.append(x.gather(-1, i))
        idxs.append(i)
        x = x.scatter(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row, ``argmax(logits + Gumbel noise)``: the
    noise is ``-log(-log(u))`` of uniforms from ``generator``, which must
    live on the logits' device.  Masked logits (``NEG_INF``) absorb any noise
    and are never drawn while a row keeps a finite logit."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


def sample_token(
    logits: torch.Tensor,
    *,
    temperature: float,
    top_p: float,
    generator: torch.Generator | None,
) -> torch.Tensor:
    """Next token of each row, with the JAX package's dispatch: temperature 0
    is the argmax of the raw logits; otherwise the logits are divided by the
    temperature, masked to the nucleus by bisection when ``top_p < 1`` and
    drawn from.  (B, V) → (B,) int32."""
    logits = logits.float()
    if temperature == 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p < 1.0:
        logits = top_p_filter_bisect(logits, top_p)
    return gumbel_argmax(logits, generator)
