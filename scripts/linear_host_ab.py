"""Host enqueue of the decode step's projections, for comparing two trees.

``fused_linear_cuda`` is called back to back with no wait on the device,
so at these shapes (device time a call below the host's) the host clock
over ``ITERS`` calls is the wrapper's enqueue: argument checks, scratch
allocations, the plan lookup and the C call with its launches.  Prints one
JSON line: microseconds a call for each role of a GPT-2 124M layer at 128
rows, bf16 weights and int8, and their sums, with the card's name and
power limit.  To compare two trees, run it from each tree's root in turns
(A, B, B, A, ...), one process each, on one card:

    python3 scripts/linear_host_ab.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as CS  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS  # noqa: E402

ITERS, REPEATS = 400, 5


def enqueue_us(fn) -> float:
    """The median over REPEATS of ITERS calls' host seconds, per call."""
    runs = []
    for _ in range(REPEATS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        runs.append((time.perf_counter() - t0) / ITERS * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[REPEATS // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("linear_host_ab: no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": os.getcwd(), "card": CS.nvidia_smi(), "iters": ITERS, "repeats": REPEATS}
    for quant in (False, True):
        roles = {}
        for name, k, n, ln, epi in CS.LINEAR_ROLES:
            x, w, bias, res, kw = CS.linear_inputs(CS.B, k, n, ln, epi, torch.bfloat16, quant, g)
            roles[name] = enqueue_us(lambda: DS.fused_linear_cuda(x, w, bias, residual=res, **kw))
        out["int8" if quant else "bf16"] = {"roles": roles, "layer_us": sum(roles.values())}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
