"""Device time of the two selection kernels by CUDA kernel, from traces.

Run on the card from the repository root:

    python3 scripts/vocab_walk_split.py [--sample] [CSRC_DIR ...]

For the port's ``csrc/`` and then each CSRC_DIR given (a copy of ``csrc/``
with an edit to try, in a folder that ``.gitignore`` lists), it builds the
kernels from that tree and prints, as one JSON line a case, the device
time of ``logits_topk_cuda`` (k 4) and, with ``--sample``, of
``logits_sample_cuda`` (temperature 1.0, top_p 0.9, k 3, 6 rounds) at B 512
and 128, bf16 and int8, split by CUDA kernel (the pre-pass, each pass of
the walk, the merge) from one ``torch.profiler`` window of 20 calls
(``chip_smoke.traced``), beside the CUDA events time of a call.  The trees
run in one process on one card, so their numbers compare.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import _build  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS  # noqa: E402


def split(run, tag: str, iters: int = 20) -> dict:
    """Mean device ms a call, in total and by kernel name."""
    run()
    torch.cuda.synchronize()
    _, events, dropped = C.traced(lambda: [run() for _ in range(iters)], tag)
    by: dict[str, list] = {}
    for e in events:
        n, t = by.get(e["name"][:70], (0, 0.0))
        by[e["name"][:70]] = (n + 1, t + e["dur"])
    return {"dropped": dropped, "total_ms": sum(e["dur"] for e in events) / iters / 1e3,
            "by_kernel": {k: {"launches": n / iters, "ms": t / iters / 1e3}
                          for k, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1])}}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("vocab_walk_split: no CUDA device", file=sys.stderr)
        return 1
    sample = "--sample" in argv
    trees = {"csrc": _build.CSRC_DIR, **{d: Path(d) for d in argv if not d.startswith("--")}}
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {False: (*C.vocab_inputs(512, torch.bfloat16, g), {}),
              True: C.int8_vocab_inputs(512, torch.bfloat16, g)}
    for name, src in trees.items():
        _build.CSRC_DIR = src
        _build.library.cache_clear()
        _build.library()
        for quant, (x32, lnf, wte, kw) in inputs.items():
            for b in (512, 128):
                x = x32[:b]
                temp = torch.full((b,), 1.0, device="cuda")
                top_p = torch.full((b,), C.TOP_P, device="cuda")
                runs = {"topk": lambda: DS.logits_topk_cuda(x, lnf, wte, 4, **kw)}
                if sample:
                    runs["sample"] = lambda: DS.logits_sample_cuda(x, lnf, wte, temp, top_p, 5, 3,
                                                                   6, **kw)
                for kind, run in runs.items():
                    rec = {"tree": name, "kernel": kind, "int8": quant, "B": b,
                           "events_ms": C.time_ms(run),
                           "split": split(run, f"split_{kind}_{b}_{int(quant)}")}
                    if kind == "sample":
                        rec["rounds_histogram"] = torch.bincount(run()[1]).tolist()
                    print(json.dumps(rec), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
