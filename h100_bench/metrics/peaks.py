"""The card's peaks, from NVIDIA's H100 SXM5 data sheet (dense rates, no
sparsity, at the full 700 W power limit).

float32 models are bounded at the TF32 dense peak with each product counted
once (2·M·N·K): no float32-grade route on the tensor cores can beat that,
whatever splits it uses.  The port's float32 products run as a three-term TF32
split (three TF32 products for each one counted), so they can reach at most a
third of this peak.
"""

from __future__ import annotations

SOURCE = "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 column, dense"

HBM_BYTES_S = 3.35e12
OPS_S = {
    "bf16": 989e12,
    "float32": 495e12,  # TF32 dense, each product counted once
    "int8": 1979e12,
}


def ops_peak(dtype: str) -> float:
    """Operations a second of products in ``dtype`` ("bf16", "float32", "int8")."""
    return OPS_S[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take for work that does ``flops``
    operations in ``dtype`` products and moves ``nbytes`` through HBM."""
    return max(flops / OPS_S[dtype], nbytes / HBM_BYTES_S)
