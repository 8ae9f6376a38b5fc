"""Ring attention over the sp axis of a ``(dp, sp)`` mesh (context
parallelism) — the counterpart of ``gpt2_image_captioning_tpu/parallel/ring.py``.

The all-gather form of sequence parallelism (``parallel/sequence.py``)
gathers the full (B, T, D) keys and values on every rank a layer.  The ring
form keeps them sequence-sharded: each rank's K/V block travels round the
sp ranks (:func:`parallel.collectives.ring_permute`, one posted send/receive
pair a tensor and step), while the rank's queries accumulate attention over
every block with an online softmax, so a rank holds O(T/sp) of them.

Each step is one dense (B, H, Tc, Tc) block in torch ops, as the JAX
package computes it in plain XLA outside any kernel: float32 scores, the
carry (m, l, acc) in float32, p cast to the policy's compute dtype before
P·V.  The finite ``NEG_INF`` (the float32 minimum) masks, so a block wholly
in a row's future leaves m at NEG_INF and ``exp(NEG_INF - NEG_INF)`` is 1,
not NaN.  A query row with no visible key returns exact zeros through the
clamped divide ``acc / max(l, 1e-30)``, as the JAX code does.

The gradient is autograd's through the loop: ``ring_permute``'s backward
sends each block's cotangent back the way the block came (the transpose of
JAX's ``ppermute``).  The rotation after the last block is left out: its
result is never read, so it would move data for nothing.
"""

from __future__ import annotations

import math

import torch

from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.parallel.collectives import ring_permute

NEG_INF = float(torch.finfo(torch.float32).min)


def ring_attention(
    q4: torch.Tensor,
    k4: torch.Tensor,
    v4: torch.Tensor,
    *,
    mesh,
    q_offset: int,
    key_mask: torch.Tensor | None = None,
    causal: bool = True,
    policy: Policy = F32,
) -> torch.Tensor:
    """Exact blockwise attention of this rank's queries over every rank's
    keys.

    q4 / k4 / v4: this rank's (B, H, Tc, hd) chunk of the sequence (sp index
    i owns the global positions [i·Tc, (i+1)·Tc), and ``q_offset`` must be
    i·Tc).  ``key_mask``: an optional (B, T) mask over the whole global
    sequence, the same on every rank (0: key hidden).  ``mesh``: a
    ``(dp, sp)`` mesh (:func:`parallel.sequence.create_sp_mesh`).  Returns
    the (B, H, Tc, hd) output of the local queries in the compute dtype —
    the contract of ``ops.nn.attention_xla`` on the gathered sequence."""
    n, i = mesh.sp, mesh.sp_rank
    b, h, tc, hd = q4.shape
    dev = q4.device
    scale = 1.0 / math.sqrt(hd)
    qf = q4.float()
    qpos = q_offset + torch.arange(tc, device=dev)  # the local queries' global positions
    m = torch.full((b, h, tc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, tc, hd), dtype=torch.float32, device=dev)
    kb, vb = k4, v4
    for s in range(n):
        koff = (i - s) % n * tc  # the held block's owner's first position
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kb.float()) * scale
        allowed = torch.ones((1, 1, tc, tc), dtype=torch.bool, device=dev)
        if causal:
            kpos = koff + torch.arange(tc, device=dev)
            allowed = allowed & (kpos[None, None, None, :] <= qpos[None, None, :, None])
        if key_mask is not None:
            allowed = allowed & (key_mask[:, None, None, koff:koff + tc] != 0)
        sc = torch.where(allowed, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(allowed, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(policy.compute_dtype),
                          vb.to(policy.compute_dtype)).float()
        acc = acc * alpha[..., None] + pv
        m = m_new
        if s < n - 1:
            kb, vb = ring_permute(mesh, kb), ring_permute(mesh, vb)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(policy.compute_dtype)
