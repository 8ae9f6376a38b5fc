"""Where a flash-attention item's time goes on the GPU: clock stamps inside
the kernel.

Copies ``gpt2_image_captioning_tpu_torch/csrc`` into the git-ignored build
folder with stamps (``clock64``) inserted into the consumer warpgroup of
``flash_attention.cuh``, builds that copy, runs the kernel once at each
shape, and prints, per shape, the mean clocks an item spends waiting for Q,
waiting for K/V (and float32's converters), in the S products, in the masks
and the softmax, in P V, and in the store, with the item's total (the
stamps of the consumer warpgroup's first thread; the items traced are those
of the first 400 blocks, up to 128 each); the stamps themselves cost a few
clocks each, so the kernel's device time is ``chip_smoke.py --only
flash``'s, from the unmodified build.  Run from the repository root on the
GPU:

    python3 scripts/flash_clocks.py

It prints one JSON line a shape and measurement.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as CS  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import _build  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import attention as A  # noqa: E402

NB, NI = 400, 128  # blocks, items a block traced
FIELDS = ("q_wait", "kv_wait", "s", "softmax", "pv", "store")
# (name, dtype, B, H, T, hd, causal, padding mask): paths' shapes of chip_smoke.py
SHAPES = (("train", torch.bfloat16, 128, 12, 65, 64, True, True),
          ("mapper", torch.bfloat16, 128, 8, 25, 96, False, False),
          ("vit", torch.bfloat16, 128, 12, 197, 64, False, False),
          ("mapper_f32", torch.float32, 128, 8, 25, 96, False, False))


def instrumented_csrc() -> Path:
    """A copy of csrc/ whose flash kernel records, per item of a block, the
    clocks of each phase into a device array read by ``gic_flash_clocks``."""
    root = _build.BUILD_DIR / "clocks_csrc"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for f in _build.CSRC_DIR.iterdir():
        shutil.copy(f, root / f.name)
    src = (root / "flash_attention.cuh").read_text()

    def insert(anchor: str, before: str = "", after: str = "") -> None:
        nonlocal src
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor + after)

    insert("namespace gic {\nnamespace flash {\n",
           after=f"static __device__ long long g_clocks[{NB} * {NI} * 8];\n")
    insert("      const Item it = item_at<T, BKV>(a, item);\n      const int qb = i % C::QBUF;\n"
           "      wait_or_trap(kF32", before="      const long long t0 = clock64();\n")
    insert("      wait_or_trap(kF32 ? &qready[qb] : &qfull[qb], (i / C::QBUF) & 1);\n",
           after="      const long long t1 = clock64();\n      long long tf = 0, ts = 0, tx = 0, tp = 0;\n")
    insert("        // S = Q K^T, both operands K-major;", before="        const long long c0 = clock64();\n")
    insert("#pragma unroll\n        for (int e = 0; e < BKV / 2; ++e) sc[e] = 0.f;\n",
           before="        tf += clock64() - c0;\n")
    insert("        if (j == it.ntiles - 1) mbar_arrive(&qempty[qb]);  // Q's last read\n",
           after="        const long long c1 = clock64();\n        ts += c1 - c0;\n")
    insert("        // O = O * alpha + P V, skipping",
           before="        const long long c2 = clock64();\n        tx += c2 - c1;\n")
    insert("        mbar_arrive(&empty[s]);\n      }\n", before="        tp += clock64() - c2;\n")
    insert("      // normalise and store rows",
           before="      const long long t2 = clock64();\n")
    insert("    }\n  }\n}\n\n// The SMs of the current device.",
           before=f"      if (tid == 0 && blockIdx.x < {NB} && i < {NI}) {{\n"
                  f"        long long* r = g_clocks + ((long long)blockIdx.x * {NI} + i) * 8;\n"
                  "        r[0] = t1 - t0; r[1] = tf; r[2] = ts - tf; r[3] = tx; r[4] = tp;\n"
                  "        r[5] = clock64() - t2; r[6] = clock64() - t0; r[7] = 1;\n      }\n")
    (root / "flash_attention.cuh").write_text(src)
    cu = root / "flash_attention.cu"
    cu.write_text(cu.read_text() + (
        "\n// Clock stamps of the instrumented copy (scripts/flash_clocks.py): clear, or read.\n"
        'extern "C" int gic_flash_clocks(long long* host, int clear) {\n'
        f"  static long long zeros[{NB} * {NI} * 8];\n"
        "  if (clear) return (int)cudaMemcpyToSymbol(gic::flash::g_clocks, zeros, sizeof(zeros));\n"
        "  return (int)cudaMemcpyFromSymbol(host, gic::flash::g_clocks, sizeof(zeros));\n}\n"))
    return root


def inputs(shape, g):
    _, dtype, b, h, t, hd, causal, masked = shape
    q, k, v, mask = CS.flash_inputs(b, h, t, hd, masked, dtype, g)
    return lambda: A.flash_attention_cuda(q, k, v, mask, causal)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_clocks: no CUDA device", file=sys.stderr)
        return 1
    CS.OUT_DIR.mkdir(exist_ok=True)
    card = CS.nvidia_smi()
    _build.CSRC_DIR = instrumented_csrc()
    lib = _build.library()
    lib.gic_flash_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_longlong * (NB * NI * 8))()
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        call = inputs(shape, g)
        call()
        torch.cuda.synchronize()
        lib.gic_flash_clocks(None, 1)
        call()
        torch.cuda.synchronize()
        lib.gic_flash_clocks(ctypes.addressof(buf), 0)
        rows = [buf[r * 8:(r + 1) * 8] for r in range(NB * NI) if buf[r * 8 + 7]]
        mean = {f: sum(r[i] for r in rows) / len(rows) for i, f in enumerate(FIELDS)}
        print(json.dumps({"shape": shape[0], "items_traced": len(rows), "mean_clocks": mean,
                          "item_total": sum(r[6] for r in rows) / len(rows), "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
