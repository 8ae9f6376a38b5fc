"""Run one cell of the benchmark once, on one NVIDIA H100.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (a workload of ``BENCHMARK.json``)
names its configuration file and its traffic (``h100_bench/traffic/<name>.json``),
whose ``kind`` names the driver (``h100_bench/drivers/<kind>.py``).  A run
makes the weights and inputs on the card from ``--seed``, warms up the
cell's shapes (set-up, ``setup_s``), measures for ``--seconds``, checks the
window's outputs against the plain reference (``correct``) and prints one
JSON line last on standard output.  ``--trace 0`` reports the cell's
end-to-end metrics; ``--trace 1`` traces the window (at most
``harness.TRACE_SECONDS``) with ``torch.profiler`` and reports its per-layer
metrics, each read by ``h100_bench/metrics/<metric>.py``, with the device's
busy and window seconds and a breakdown of the trace.

Two options serve the limits' readings and are not part of a check:
``--control 1`` puts the cell's control (the lower precision) in the
program's place, and ``--fault <name>`` plants a fault of
``h100_bench/faults.py``.

The run refuses, with no result, where there is no card (or fewer than the
cell asks for), and where JAX or the JAX package is loaded when the window
has closed.  Build and kernel caches stay inside the checkout: the port's
library in its ``_build/``, Triton's under ``h100_bench/.cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def environment() -> None:
    """The run's imports come from the checkout's root (not this
    directory), and every cache stays in the checkout."""
    sys.path[0] = str(ROOT)
    os.environ["TRITON_CACHE_DIR"] = str(BENCH_DIR / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH_DIR / ".cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"  # keeps transformers, if anything loads it, off JAX


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def read_metric(name: str, ctx):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def main(argv: list[str]) -> int:
    args = parse(argv)
    from h100_bench import guard

    found = guard.loaded_banned()
    bad_ref = guard.reference_imports()
    if found or bad_ref:
        print(f"refused: loaded {found}; reference imports {bad_ref}", file=sys.stderr)
        return 3
    import torch

    from h100_bench import harness as H
    from h100_bench.metrics import trace as T

    bench = H.benchmark()
    work, _ = H.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"refused: {args.workload} needs {work['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    cell = H.load_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                       control=bool(args.control), fault=args.fault)
    out = H.driver(cell.traffic["kind"]).run(cell)

    found = guard.loaded_banned()
    if found:
        print(f"refused: {found} loaded by the run", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed}
    if cell.trace:
        win = out.trace
        ctx = H.ReadContext(cell.config, cell.traffic, win, out.counts)
        metrics = {}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=win.busy_s, window_s=win.window_s)
        result.update(metrics=metrics, device=device,
                      breakdown={"device_ops": T.device_ops(win), "idle_gaps": T.idle_gaps(win)})
        print(f"trace: {len(win.events)} device events, {win.dropped} launches without a "
              f"device record", file=sys.stderr)
    else:
        values = dict(out.e2e, setup_s=out.window_start - T_START)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, args.workload, "end_to_end")}
        result.update(metrics=metrics, device=device)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.compared.items()}
    for line in out.notes:
        print(line, file=sys.stderr)
    print(f"card: {nvidia_smi()}", file=sys.stderr)
    for k, (v, lim) in out.compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def nvidia_smi() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


if __name__ == "__main__":
    environment()
    sys.exit(main(sys.argv[1:]))
