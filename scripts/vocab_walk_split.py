"""Device time of the vocabulary kernels by CUDA kernel, from traces.

Run on the card from the repository root:

    python3 scripts/vocab_walk_split.py [--kernels topk,sample,argmax,logits]
                                        [--float32] [CSRC_DIR ...]

For the port's ``csrc/`` and then each CSRC_DIR given (a copy of ``csrc/``
with an edit to try, in a folder that ``.gitignore`` lists), it builds the
kernels from that tree and prints, as one JSON line a case, the device
time of each kernel named (default ``topk``): ``logits_topk_cuda`` (k 4),
``logits_sample_cuda`` (temperature 1.0, top_p 0.9, k 3, 6 rounds),
``logits_argmax_cuda`` and ``logits_cuda``, at B 512 and 128, bf16 and int8
(with ``--float32`` also float32 wte), split by CUDA kernel (the pre-pass,
each pass of the walk, the merge) from one ``torch.profiler`` window of 20
calls (``chip_smoke.traced``), beside the CUDA events time of a call and
the largest difference from the plain twin (the logits, or the ids'
share that equals the twin's).  Each tree runs in a process of its own,
one after the other on one card, so their numbers compare.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import _build  # noqa: E402
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS  # noqa: E402

KERNELS = ("topk", "sample", "argmax", "logits")


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


def agreement(kind: str, got, x, lnf, wte, kw) -> dict:
    """How far a wrapper's output lies from its twin's on the same inputs."""
    if kind == "logits":
        return {"max_abs_err": float((got - DS.logits_plain(x, lnf, wte, **kw)).abs().max())}
    if kind == "argmax":
        want = DS.logits_argmax_plain(x, lnf, wte, **kw)
        return {"ids_equal": float((got == want).float().mean())}
    return {}


def run_tree(name: str, kinds: list[str], float32: bool) -> None:
    """Every case of one tree, printed as it is measured."""
    if name != "csrc":
        _build.CSRC_DIR = Path(name).resolve()
        _build.library.cache_clear()
    _build.library()
    tag = Path(name).name
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"bf16": (*C.vocab_inputs(512, torch.bfloat16, g), {}),
              "int8": C.int8_vocab_inputs(512, torch.bfloat16, g)}
    if float32:
        inputs["float32"] = (*C.vocab_inputs(512, torch.float32, g), {})
    for wname, (x32, lnf, wte, kw) in inputs.items():
        for b in (512, 128):
            x = x32[:b].contiguous()
            temp = torch.full((b,), 1.0, device="cuda")
            top_p = torch.full((b,), C.TOP_P, device="cuda")
            runs = {"topk": lambda: DS.logits_topk_cuda(x, lnf, wte, 4, **kw),
                    "sample": lambda: DS.logits_sample_cuda(x, lnf, wte, temp, top_p, 5, 3, 6,
                                                            **kw),
                    "argmax": lambda: DS.logits_argmax_cuda(x, lnf, wte, **kw),
                    "logits": lambda: DS.logits_cuda(x, lnf, wte, **kw)}
            for kind in kinds:
                run = runs[kind]
                rec = {"tree": name, "kernel": kind, "weights": wname, "B": b,
                       **agreement(kind, run(), x, lnf, wte, kw),
                       "events_ms": C.time_ms(run),
                       "split": split(run, f"split_{tag}_{kind}_{wname}_{b}.json")}
                if kind == "sample":
                    rec["rounds_histogram"] = torch.bincount(run()[1]).tolist()
                print(json.dumps(rec), flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("vocab_walk_split: no CUDA device", file=sys.stderr)
        return 1
    kinds, float32, trees = ["topk"], False, ["csrc"]
    it = iter(argv)
    for arg in it:
        if arg == "--kernels":
            kinds = next(it).split(",")
            if not set(kinds) <= set(KERNELS):
                print(f"vocab_walk_split: kernels are {KERNELS}", file=sys.stderr)
                return 2
        elif arg == "--float32":
            float32 = True
        elif arg == "--tree":  # one tree, in this process
            run_tree(next(it), kinds, float32)
            return 0
        else:
            trees.append(arg)
    C.OUT_DIR.mkdir(exist_ok=True)
    flags = ["--kernels", ",".join(kinds)] + ["--float32"] * float32
    for name in trees:
        proc = subprocess.run([sys.executable, __file__, *flags, "--tree", name])
        if proc.returncode:
            print(f"vocab_walk_split: tree {name} exited with {proc.returncode}", file=sys.stderr)
            return proc.returncode
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
