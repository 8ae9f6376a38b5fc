"""``python -m gpt2_image_captioning_tpu_torch`` — the environment check: torch
and CUDA versions, each CUDA device with its power limit, the kernel
library for the current sources and ``nvcc``, the native components, and
the tokenizer assets.  Exits 1 when no CUDA device is visible: the port
runs on the card.  ``--help`` touches no device."""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def _power_limits() -> list[str]:
    """``name, power.limit`` of each GPU as nvidia-smi reports them (empty
    where nvidia-smi is missing or fails)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    return out.stdout.strip().splitlines() if out.returncode == 0 else []


def check() -> int:
    """Print the environment; 0 when a CUDA device is visible, 1 otherwise."""
    import torch

    from gpt2_image_captioning_tpu_torch.data import native_bpe, native_pipe
    from gpt2_image_captioning_tpu_torch.ops import _build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none (a CPU build)'}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    limits = _power_limits()
    for i in range(n):
        limit = limits[i].split(",")[-1].strip() if i < len(limits) else "unknown"
        print(f"  cuda:{i}: {torch.cuda.get_device_name(i)} (power limit {limit})")
    if n == 0:
        print("  no CUDA device visible")
    lib = _build.BUILD_DIR / _build.source_hash() / _build.LIB_NAME
    state = f"built ({lib})" if lib.exists() else "not built yet (built by nvcc at first use)"
    print(f"kernel library for the current sources: {state}")
    try:
        print(f"nvcc: {_build._nvcc()}")
    except RuntimeError as e:
        print(f"nvcc: not found ({e})")
    for name, mod in (("image pipeline", native_pipe), ("BPE engine", native_bpe)):
        state = "built" if mod.available() else "NOT built (make -C native)"
        print(f"native {name}: {state}")
    for place in (os.environ.get("GPT2_TOKENIZER_DIR"), "assets/gpt2"):
        if place:
            found = os.path.exists(os.path.join(place, "vocab.json"))
            print(f"GPT-2 tokenizer in {place}: "
                  + ("present" if found else "missing (scripts/download_assets.sh)"))
    if n == 0:
        print("the port runs on a CUDA device; none is visible", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gpt2_image_captioning_tpu_torch",
        description="Environment check of the PyTorch + CUDA port: torch and CUDA "
        "versions, CUDA devices and their power limits, the kernel library and nvcc, "
        "the native components, the tokenizer assets. Takes no arguments; exits 1 "
        "without a CUDA device.",
    )
    parser.parse_args(argv)
    return check()


if __name__ == "__main__":
    sys.exit(main())
