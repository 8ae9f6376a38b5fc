"""Device time of every split of the decode step's projections on the GPU.

``csrc/fused_linear.cu`` runs its bf16 and int8 products in the split that
``ops/decode_step.py::linear_plan`` picks by a model of the bytes a block
streams.  This script times each split that ``linear_plan_options`` allows
(column width, K-slices) for the four roles of a GPT-2 124M layer, bf16 and
int8, at 128 and 512 rows: the product kernel's device time and the whole
call's (with its LayerNorm or quantizer pre-pass) from a ``torch.profiler``
trace of 20 calls each (``chip_smoke.device_split``), the planned split
marked, and how many microseconds the planned split lies above the fastest
one and the fastest one with a block on every SM (``planned_over_us``).
Run from the repository root on a machine with the card:

    python3 scripts/linear_plan_sweep.py

It prints one JSON line a role and writes them all to
``chiprun_out/linear_plan_sweep.json``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as CS  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS  # noqa: E402

PRODUCT = "linear_wgmma_kernel"


def sweep_role(name, b, k, n, ln, epi, quant, g) -> dict:
    x, w, bias, res, kw = CS.linear_inputs(b, k, n, ln, epi, torch.bfloat16, quant, g)
    el = 1 if quant else 2
    planned = DS.linear_plan(b, k, n, el)
    chosen = DS.linear_plan
    rows = []
    try:
        for plan in DS.linear_plan_options(b, k, n, el):
            DS.linear_plan = lambda *_, p=plan: p
            err, _ = CS.linear_error(x, w, bias, res, kw, torch.bfloat16)
            r = None if res is None else res.clone()
            dev = CS.device_split(lambda: DS.fused_linear_cuda(x, w, bias, residual=r, **kw),
                                  (PRODUCT,), f"sweep_{name}_b{b}_{el}.json")
            rows.append({"bn": plan.bn, "splits": plan.splits, "k_slice": plan.k_slice,
                         "blocks": plan.blocks, "stages": plan.stages,
                         "planned": plan == planned, "max_abs_err": err,
                         "product_device_ms": dev if isinstance(dev, str) else dev[PRODUCT],
                         "call_device_ms": dev if isinstance(dev, str) else dev["total"]})
    finally:
        DS.linear_plan = chosen
    timed = [r for r in rows if not isinstance(r["product_device_ms"], str)]
    # the fastest split, and the fastest that gives every SM a block (as the plan must)
    wave = min(DS.SMS, max(r["blocks"] for r in rows))
    best = min(timed, key=lambda r: r["product_device_ms"]) if timed else None
    best_wave = min((r for r in timed if r["blocks"] >= wave),
                    key=lambda r: r["product_device_ms"], default=None)
    mine = next((r for r in timed if r["planned"]), None)
    over = {key: (mine["product_device_ms"] - ref["product_device_ms"]) * 1e3
            for key, ref in (("best", best), ("best_full_wave", best_wave))
            if mine is not None and ref is not None}
    return {"role": name, "rows_b": b, "type": "int8" if quant else "bf16", "K": k, "N": n,
            "planned": planned._asdict(), "best": best, "best_full_wave": best_wave,
            "planned_over_us": over, "splits": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("linear_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    CS.OUT_DIR.mkdir(exist_ok=True)
    card = CS.nvidia_smi()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for quant in (False, True):
        for b in (CS.B, CS.B_BEAM):
            for name, k, n, ln, epi in CS.LINEAR_ROLES:
                rec = {**sweep_role(name, b, k, n, ln, epi, quant, g), "card": card}
                out.append(rec)
                print(json.dumps(rec), flush=True)
    (CS.OUT_DIR / "linear_plan_sweep.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
