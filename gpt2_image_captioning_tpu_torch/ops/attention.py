"""Attention dispatcher, the counterpart of ``gpt2_image_captioning_tpu/ops/attention.py::mha``.

The JAX package's default is its plain XLA formula; its Pallas flash kernel
(``ops/attention.py::_flash_kernel``) is opt-in and not yet ported (ROADMAP,
queue 2, item 4), so the port runs :func:`ops.nn.attention_xla`.  The
kernel's port will be selected here.
"""

from __future__ import annotations

import torch

from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.ops import nn


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_mask: torch.Tensor | None = None,
    q_offset: int = 0,
    policy: Policy | None = None,
) -> torch.Tensor:
    return nn.attention_xla(
        q, k, v, causal=causal, key_mask=key_mask, q_offset=q_offset, policy=policy or F32
    )
