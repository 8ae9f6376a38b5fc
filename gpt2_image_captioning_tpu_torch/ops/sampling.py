"""Token selection for decoding — the counterpart of
``gpt2_image_captioning_tpu/ops/sampling.py``: temperature scaling, the top-p
(nucleus) mask, a small top-k, and the categorical draw; and the plain twin
of the step's in-kernel sampler (``csrc/logits_sample.cu``).

These are XLA ops in the JAX package, not Pallas kernels, so here they are
torch ops.  The masks are the JAX package's exactly; the random draws are
not (``torch.Generator`` is not ``jax.random``), only their distribution is:
the categorical draw is Gumbel-max, the method ``jax.random.categorical``
uses, on uniforms from the caller's generator.

The in-kernel sampler draws its noise from Philox4x32-10 (Random123), which
:func:`philox4x32_10` writes in torch integer ops, so :func:`sample_step_plain`
reproduces the kernel's draws token for token.  Continuous serving keys its
noise off a monotone step counter with :func:`fold_seed`.
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


def sample_rows(logits: torch.Tensor, temp: torch.Tensor, top_p: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """Per-row temperature / top-p draw (the JAX macro engine's
    ``sample_rows``): row r's logits divided by ``temp[r]``, masked to the
    nucleus of ``top_p[r]`` by bisection and drawn from; rows with
    ``temp <= 0`` take the argmax of the raw logits.  logits (B, V); temp,
    top_p (B,) float32 → (B,) int32."""
    lg32 = logits.float()
    greedy = torch.argmax(lg32, dim=-1).to(torch.int32)
    tsafe = torch.where(temp > 0, temp, 1.0)
    filtered = top_p_filter_bisect(lg32 / tsafe[:, None], top_p[:, None])
    return torch.where(temp > 0, gumbel_argmax(filtered, generator), greedy)


_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, counter: int) -> int:
    """A 64-bit seed for draw ``counter`` of the stream ``seed`` (SplitMix64's
    finaliser over ``seed`` and ``counter``): distinct counters give
    unrelated seeds, so a stream keyed by a monotone counter never reuses
    noise.  The counterpart of ``jax.random.fold_in``."""
    z = (seed * 0x9E3779B97F4A7C15 + (counter + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _mulhilo32(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of a * m for uint32 values held in int64,
    from 16-bit pieces so no partial product reaches 2^63."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    t = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi
    low = t + ((mid & 0xFFFF) << 16)
    return (a_hi * m_hi + (mid >> 16) + (low >> 32)) & _MASK32, low & _MASK32


def philox4x32_10(counter: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32``) of
    each 4-word counter: counter (..., 4) int64 holding uint32 words, key two
    uint32 words; returns (..., 4) int64 uint32 words, the words
    ``csrc/logits_sample.cu`` computes."""
    c0, c1, c2, c3 = counter.to(torch.int64).unbind(-1)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for i in range(10):
        if i:
            k0, k1 = (k0 + 0x9E3779B9) & _MASK32, (k1 + 0xBB67AE85) & _MASK32
        hi0, lo0 = _mulhilo32(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo32(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_words(seed: int, b: int, v: int, round_: int, k: int, device) -> torch.Tensor:
    """The sampler's noise words of one round: (b, v, k) int64, word c of the
    Philox block at counter (row, column, round, 0) under the key
    (seed & 0xFFFFFFFF, seed >> 32)."""
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None].expand(b, v)
    cols = torch.arange(v, dtype=torch.int64, device=device)[None, :].expand(b, v)
    ctr = torch.stack([rows, cols, torch.full_like(rows, round_), torch.zeros_like(rows)], -1)
    return philox4x32_10(ctr, (seed & _MASK32, (seed >> 32) & _MASK32))[..., :k]


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """Uniform 32-bit words to standard Gumbel noise as the TPU kernel does it
    (``gpt2_image_captioning_tpu/ops/decode_step.py:671-678``): 23 bits to u
    in (0, 1), exactly, then -log(-log(u))."""
    u = (bits & 0x7FFFFF).to(torch.float32) * (2.0 ** -23) + (2.0 ** -24)
    return -torch.log(-torch.log(u))


def sample_step_plain(x32, lnf, wte, temp, top_p, seed: int, k: int = 3, rounds: int = 6,
                      bits=None, eps: float = 1e-5, **quant):
    """Plain twin of ``csrc/logits_sample.cu``, the step's in-kernel
    temperature / top-p draw by speculative accept.

    The logits (:func:`ops.decode_step.logits_plain`) are scaled by
    1/``temp`` (rows with ``temp <= 0``: unscaled, and they take the argmax,
    ties to the lowest id, in round 0).  ``k`` Gumbel-max candidates are
    drawn over the full scaled softmax; in round r = 1..``rounds`` a
    candidate is accepted iff the probability mass strictly above its scaled
    logit is <= ``top_p``, the first accepted in candidate order wins, and
    the round draws ``k`` fresh candidates for the next one.  A row still
    unresolved takes the last round's first fresh candidate and reports
    ``rounds + 1``.  ``bits(round)`` gives the (B, V, k) uniform words of a
    round; None means :func:`philox_words` under ``seed``, the kernel's.
    ``quant``: ``wte_scale`` and ``compute_dtype`` for an int8 wte, as in
    :func:`ops.decode_step.logits_plain`.  Returns (token (B,) int32, resolve
    round (B,) int32, logsumexp of the scaled logits (B, 1) float32).
    """
    from gpt2_image_captioning_tpu_torch.ops.decode_step import logits_plain

    lg = logits_plain(x32, lnf, wte, eps, **quant)
    b, v = lg.shape
    if bits is None:
        def bits(r):
            return philox_words(seed, b, v, r, k, lg.device)
    temp = temp.float()
    tinv = torch.where(temp > 0, 1.0 / torch.where(temp > 0, temp, 1.0), 1.0)
    lq = lg * tinv[:, None]
    lse = torch.logsumexp(lq, dim=-1, keepdim=True)
    prob = torch.exp(lq - lse)

    def draw(r):
        pert = lq[:, :, None] + gumbel_of_bits(bits(r))  # (B, V, k)
        col = torch.argmax(pert, dim=1)  # the first column of the max
        return col, lq.gather(1, col)

    chosen = torch.argmax(lq, dim=-1)
    rnd = torch.zeros(b, dtype=torch.int64, device=lg.device)
    unres = temp > 0
    cc, cl = draw(0)
    for r in range(1, rounds + 1):
        if not bool(unres.any()):
            break
        mass = torch.stack([torch.where(lq > cl[:, c : c + 1], prob, 0.0).sum(dim=-1)
                            for c in range(k)], dim=-1)
        fresh = draw(r)
        for c in range(k):
            take = unres & (mass[:, c] <= top_p)
            chosen = torch.where(take, cc[:, c], chosen)
            rnd = torch.where(take, r, rnd)
            unres = unres & ~take
        cc, cl = fresh
    chosen = torch.where(unres, cc[:, 0], chosen)
    rnd = torch.where(unres, rounds + 1, rnd)
    return chosen.to(torch.int32), rnd.to(torch.int32), lse
