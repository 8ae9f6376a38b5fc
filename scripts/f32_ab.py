"""The float32 projections, prefill and decode paths of one tree on the GPU.

Times, from the tree in the current directory (its ``chip_smoke.py`` and
its package), what the float32 route of ``csrc/fused_linear.cu`` and
``csrc/prefill.cu`` moves: one layer's four projections at B 128 and at
512 rows (events ms, device ms from a trace, ``addmm`` x 4's device ms),
the prefill of 128 images x 15 tokens (device ms by part) and the façade's
float32 decodes at b 128 — greedy, top-p sampled in the kernel, beam-4 at
512 rows — (img/s, device ms a step and idle share from one traced
request).  To compare two trees on one card, run it from each tree's root
in one call, in turns (parent, change, change, parent):

    cd PARENT && python3 /path/to/scripts/f32_ab.py parent
    cd CHANGE && python3 scripts/f32_ab.py change

It prints one JSON line a measurement, tagged with the name given, and
appends them to ``chiprun_out/f32_ab.jsonl`` under the current directory.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as CS  # noqa: E402  (the current tree's)


def main() -> int:
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    if not torch.cuda.is_available():
        print("f32_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from gpt2_image_captioning_tpu_torch.ops import _build

    _build.library()
    CS.OUT_DIR.mkdir(exist_ok=True)
    card = CS.nvidia_smi()

    def emit(what: str, rec: dict) -> None:
        line = json.dumps({"tree": tag, "what": what, "card": card, **rec})
        print(line, flush=True)
        with open(CS.OUT_DIR / "f32_ab.jsonl", "a") as out:
            out.write(line + "\n")

    g = torch.Generator(device="cuda").manual_seed(0)
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "plain_ms",
            "max_abs_err")
    for b in (CS.B, CS.B_BEAM):
        layer = CS.linear_layer(torch.float32, False, b, True, g)
        emit(f"fused_linear_b{b}", {**{k: layer.get(k) for k in keys},
                                    "roles_device_ms": {n: r.get("device_ms")
                                                        for n, r in layer["roles"].items()}})
    pre = CS.check_prefill(torch.float32, g)["shapes"][f"b{CS.B}"]
    emit("prefill_b128", {k: pre.get(k) for k in keys + ("device_ms_by_part",)})
    model, reqs = CS.serving_model()
    paths = (("greedy_f32", lambda: CS.greedy_path(model, reqs, "f32")),
             ("in_kernel_f32", lambda: CS.sampled_path(model, reqs, "f32", in_kernel=True)),
             ("beam_f32", lambda: CS.beam_f32_path(model, reqs)))
    for path, fn in paths:
        t0 = time.perf_counter()
        record, _, prof = fn()
        steps = prof.get("decode_steps") or 49
        busy = prof.get("device_busy_s")
        emit(path, {"img_per_s": record["img_per_s_kernels"], "seconds": time.perf_counter() - t0,
                    "device_ms_per_step": None if busy is None else 1e3 * busy / steps,
                    "idle_share": prof.get("idle_share"),
                    "idle_share_est_unprofiled": prof.get("idle_share_est_unprofiled"),
                    "port_kernels_s_by_name": prof.get("port_kernels_s_by_name"),
                    "teacher_forced": record.get("teacher_forced")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
