"""Where the port's entry points run: on the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    no CUDA device, rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; the port runs "
            "on the GPU by default — pass device='cpu' to run its plain PyTorch path on the CPU"
        )
    return dev
