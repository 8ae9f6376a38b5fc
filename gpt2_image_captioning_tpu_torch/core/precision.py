"""Mixed-precision policy for the PyTorch port.

Parameters live in float32; matmul-heavy compute runs in the policy's compute
dtype (bfloat16 for serving) with float32 accumulation.  LayerNorm statistics
and softmax always run in float32.  ``F32`` (all-float32) is what the parity
tests against the JAX package use.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != self.compute_dtype and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x

    @staticmethod
    def f32() -> "Policy":
        return Policy(torch.float32, torch.float32)

    @staticmethod
    def bf16() -> "Policy":
        return Policy(torch.float32, torch.bfloat16)


F32 = Policy.f32()
BF16 = Policy.bf16()


def cast_floating(tree, dtype: torch.dtype = torch.bfloat16):
    """Cast every floating-point tensor of a nested dict/list of params to
    ``dtype``.  Decode reads every weight once per step, so storing them in
    bfloat16 halves the bytes a step reads; keep float32 masters for
    training."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)
