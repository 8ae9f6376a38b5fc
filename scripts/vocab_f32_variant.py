"""Write the fallback design of the float32 selection walks into a copy of
the kernels' sources, for ``scripts/vocab_walk_split.py`` to time beside
the port's own.

Run from the repository root:

    python3 scripts/vocab_f32_variant.py OUT_DIR

OUT_DIR (a folder that ``.gitignore`` lists, e.g. ``scratch_chip/``) gets a
copy of ``gpt2_image_captioning_tpu_torch/csrc/`` in which the float32 walk
(``csrc/vocab_walk.cuh``) has three converter warps instead of seven and no
register trade: a block of 12 warps, which leaves a thread 168 registers,
enough for the top-k's and the sampler's selections without ``setmaxnreg``.
Then, on the card:

    python3 scripts/vocab_walk_split.py --kernels topk,sample --float32 OUT_DIR
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gpt2_image_captioning_tpu_torch" / "csrc"

# (file, text of the port's design, text of the fallback), each found once
EDITS = (
    ("vocab_walk.cuh", "constexpr int VW_CONVERTERS = 224;", "constexpr int VW_CONVERTERS = 96;"),
    ("vocab_walk.cuh", "constexpr bool kRealloc = kF32 && Sel::kSteps > 0;",
     "constexpr bool kRealloc = false;"),
    ("vocab_walk.cuh", "  if (std::is_same<E, float>::value) {\n    int r[2];",
     "  if (false) {\n    int r[2];"),
)


def main(out: str) -> None:
    dst = Path(out).resolve()
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for name, old, new in EDITS:
        path = dst / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to replace is not there once: {old!r}")
        path.write_text(text.replace(old, new))
    print(f"wrote the three-converter walk to {dst}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
