"""Where the float32 patch embedding's time goes on the GPU: clock stamps
inside the kernel, and the kernel with parts of its work left out.

Copies ``gpt2_image_captioning_tpu_torch/csrc`` into the git-ignored build
folder, edits ``patch_embed.cu``'s float32 route (``patch_embed_kernel_tf32``)
and builds each copy:

- ``clocks``: ``clock64`` stamps in one block (column tile 1, row tile 20)
  of each launch: the service warpgroup's threads 0 and 127 (waiting for a
  free ring slot; W's TMA issue and the normalisation into the TF32 pair;
  the ready arrival; the rest of the loop) and each consumer warpgroup's
  first thread (waiting for W to land and for the pixels; loading and
  splitting the W^T fragments; issuing the products; waiting for them; the
  rest), summed over the block's stages and printed as clocks a stage at
  each tower's shape.  The stamps cost some clocks each (a global atomic
  add), so the segments read high; the kernel's device time is
  ``chip_smoke.py --only patch``'s, from the unmodified build.
- ``parts``: ms a call at each tower (CUDA events over 20 calls) of the
  unmodified kernel, then with the normalisation left out
  (``no_normalise``: the service writes nothing), the products left out
  (``no_products``) and both; the outputs are wrong there by design, only
  the times are read.

Run from the repository root on the GPU:

    python3 scripts/patch_clocks.py

It prints one JSON line a measurement.
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
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import SPECS  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import _build  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import patch_embed as PE  # noqa: E402

SERVICE = ("slot_wait", "tma_and_normalise", "arrive", "loop")
CONSUMER = ("w_wait", "pixels_wait", "fragments", "issue", "products_wait", "loop")
SOURCE = _build.CSRC_DIR

NORMALISE = """      if (per_channel)
        pf_normalise<C, true>"""
SKIP_NORMALISE = """      if (true) {
      } else if (per_channel)
        pf_normalise<C, true>"""
PRODUCTS = """      WgmmaRS128::tf32(acc, al, dxh);
      WgmmaRS128::tf32(acc, ah, wgmma_desc(xl + 32 * kk, 16, 1024));
      WgmmaRS128::tf32(acc, ah, dxh);
"""


def variant(name: str, edits: list[tuple[str, str]]) -> Path:
    """A copy of csrc/ with ``edits`` (anchor, replacement) in patch_embed.cu."""
    root = _build.BUILD_DIR / f"patch_{name}_csrc"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for f in SOURCE.iterdir():
        shutil.copy(f, root / f.name)
    src = (root / "patch_embed.cu").read_text()
    for anchor, new in edits:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, new)
    (root / "patch_embed.cu").write_text(src)
    return root


def stamp(i: str) -> str:
    return f"      PF_STAMP({i});\n"


def clock_edits() -> list[tuple[str, str]]:
    """Stamps into the float32 route and a C entry that reads and resets them."""
    s_wait = "      if (kt >= PF_STAGES) wait_or_trap(&empty[slot], (kt / PF_STAGES - 1) & 1);\n"
    s_arrive = "      mbar_arrive(&ready[slot]);\n    };\n"
    c_wait = "    wait_or_trap(&landed[slot], (kt / PF_STAGES) & 1);\n"
    c_ready = "    wait_or_trap(&ready[slot], (kt / PF_STAGES) & 1);\n"
    c_fence = "      wgmma_fence_regs(al);\n      wgmma_fence();\n"
    c_commit = "      wgmma_commit();\n      // the fragment's registers"
    c_wait0 = "      wgmma_wait<0>();\n      wgmma_fence_regs(acc);\n"
    head = "// Whether ``v`` holds in every thread of named barrier"
    return [
        (head, "__device__ unsigned long long pf_clk[32];\n"
               "#define PF_STAMP(i) do { if (probe) { const long long t1 = clock64(); \\\n"
               "  atomicAdd(&pf_clk[(i)], (unsigned long long)(t1 - t0)); t0 = t1; } } while (0)\n"
               + head),
        ("    const long long base = patch_corner(m0 + st, M, S, p);\n",
         "    const long long base = patch_corner(m0 + st, M, S, p);\n"
         "    const bool probe = blockIdx.x == 1 && blockIdx.y == 20 && (st == 0 || st == 127);\n"
         "    const int pb = st == 0 ? 0 : 4;\n    long long t0 = clock64();\n"),
        (s_wait, stamp("pb + 3") + s_wait + stamp("pb + 0")),
        ("      fence_proxy_async();  // the tiles, before", stamp("pb + 1")
         + "      fence_proxy_async();  // the tiles, before"),
        (s_arrive, "      mbar_arrive(&ready[slot]);\n" + stamp("pb + 2") + "    };\n"),
        ("  float acc[64], run[64];",
         "  const bool probe = blockIdx.x == 1 && blockIdx.y == 20 && threadIdx.x % 128 == 0;\n"
         "  const int pb = 8 + 6 * g;\n  long long t0 = clock64();\n  float acc[64], run[64];"),
        (c_wait, "  " + stamp("pb + 5") + c_wait + "  " + stamp("pb + 0")),
        (c_ready, c_ready + "  " + stamp("pb + 1")),
        (c_fence, c_fence.replace("      wgmma_fence();", stamp("pb + 2") + "      wgmma_fence();")),
        (c_commit, "      wgmma_commit();\n" + stamp("pb + 3") + "      // the fragment's registers"),
        (c_wait0, c_wait0 + stamp("pb + 4")),
        ("}  // namespace gic\n\n// pixels (B, S, S, 3) uint8",
         "}  // namespace gic\n\nextern \"C\" int gic_patch_clocks(unsigned long long* host, int reset) {\n"
         "  if (reset) {\n    unsigned long long z[32] = {0};\n"
         "    return (int)cudaMemcpyToSymbol(gic::pf_clk, z, sizeof(z));\n  }\n"
         "  return (int)cudaMemcpyFromSymbol(host, gic::pf_clk, 32 * sizeof(unsigned long long));\n"
         "}\n\n// pixels (B, S, S, 3) uint8"),
    ]


def tower_inputs():
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, b, p, d, _ in CS.TOWERS:
        px = torch.randint(0, 256, (b, 224, 224, 3), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
        w = 0.02 * torch.randn(3 * p * p, d, generator=g, device="cuda")
        mean, inv = PE.normalization_vectors(SPECS[name], p, "cuda")
        yield name, p, (px, w, mean, inv, p, None)


def use(tree: Path):
    _build.CSRC_DIR = tree
    _build.library.cache_clear()
    return _build.library()


def clocks() -> None:
    lib = use(variant("clocks", clock_edits()))
    fn = lib.gic_patch_clocks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name, p, args in tower_inputs():
        for _ in range(3):
            PE.patch_embed_cuda(*args)
        torch.cuda.synchronize()
        fn(None, 1)
        PE.patch_embed_cuda(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        fn(ctypes.addressof(buf), 0)
        stages = 3 * -(-p * p // 32)
        a = [v / stages for v in buf]
        out = {f"service_{t}": dict(zip(SERVICE, (round(x) for x in a[4 * i:4 * i + 4])))
               for i, t in enumerate((0, 127))}
        for g in range(2):
            out[f"consumer_wg{g}"] = dict(zip(CONSUMER, (round(x) for x in a[8 + 6 * g:14 + 6 * g])))
        print(json.dumps({"measure": "clocks_a_stage", "tower": name, "stages": stages, **out}),
              flush=True)


def parts() -> None:
    trees = {"whole": SOURCE,
             "no_normalise": variant("no_normalise", [(NORMALISE, SKIP_NORMALISE)]),
             "no_products": variant("no_products", [(PRODUCTS, "")]),
             "neither": variant("neither", [(NORMALISE, SKIP_NORMALISE), (PRODUCTS, "")])}
    for label, tree in trees.items():
        use(tree)
        times = {name: CS.time_ms(lambda: PE.patch_embed_cuda(*args))
                 for name, _, args in tower_inputs()}
        print(json.dumps({"measure": "events_ms", "kernel": label, **times}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("patch_clocks: no CUDA device")
    print(json.dumps({"card": CS.nvidia_smi()}), flush=True)
    clocks()
    parts()
