"""What every kind of cell shares: the cell as the run sees it, the files
found by name, the port's model built on the benchmark's weights, and the
outcome a driver hands back.

A cell is found by name in ``BENCHMARK.json``; its configuration is the
file that entry names, its traffic ``traffic/<name>.json`` and its limits
``limits/<cell name>.json``.  The traffic file's ``kind`` names the driver,
``drivers/<kind>.py``, which runs the set-up, the window and the check.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False       # put the cell's control in the program's place
    fault: str | None = None    # plant one of faults.FAULTS under the timed path


@dataclass
class Outcome:
    """What a driver hands back: the window's end-to-end values by metric
    name, the work attempted and failed, when the window opened (host
    clock), the peak device memory, each compared number as (value, limit),
    and, in a traced run, the trace and the counts the readers need."""
    e2e: dict
    attempted: int
    failed: int
    window_start: float
    memory_peak_bytes: int
    compared: dict
    trace: object = None
    counts: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.compared.values())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bench: dict, workload: str) -> tuple[dict, dict]:
    """(workload entry, configuration entry) of ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def load_cell(workload: str, seed: int, seconds: float, trace: bool, device,
              control: bool = False, fault: str | None = None) -> Cell:
    w, c = find_cell(benchmark(), workload)
    return Cell(name=workload, config=load_json(ROOT / c["file"]),
                traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace, device=torch.device(device),
                control=control, fault=fault)


def driver(kind: str):
    return importlib.import_module(f"h100_bench.drivers.{kind}")


# ---------------------------------------------------------------------------
# The system under test, on the benchmark's weights
# ---------------------------------------------------------------------------

def port_configs(cfg: dict):
    """The port's CaptionerConfig for a configuration file."""
    from gpt2_image_captioning_tpu_torch.models.captioner import CaptionerConfig
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import TransformerMappingConfig

    g, m = cfg["gpt2"], cfg["mapping"]
    return CaptionerConfig(
        gpt2=GPT2Config(vocab_size=g["vocab_size"], n_positions=g["n_positions"],
                        n_embd=g["n_embd"], n_layer=g["n_layer"], n_head=g["n_head"],
                        layer_norm_epsilon=g["layer_norm_epsilon"]),
        mapping=TransformerMappingConfig(
            embed_dim=m["embed_dim"], gpt_dim=m["gpt_dim"], prefix_length=m["prefix_length"],
            hidden_length=m["hidden_length"], num_layers=m["num_layers"],
            num_heads=m["num_heads"], layer_norm_eps=m["layer_norm_eps"]),
        eos_token_id=cfg["eos_token_id"])


def vision_config(cfg: dict):
    from gpt2_image_captioning_tpu_torch.models.clip import CLIPVisionConfig

    v = cfg["vision"]
    return CLIPVisionConfig(hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
                            num_hidden_layers=v["num_hidden_layers"],
                            num_attention_heads=v["num_attention_heads"],
                            image_size=v["image_size"], patch_size=v["patch_size"],
                            projection_dim=v["projection_dim"], layer_norm_eps=v["layer_norm_eps"])


def port_model(cfg: dict, mp: dict, gpt: dict, device):
    """The port's façade (``ImageCaptioningModel``) holding the benchmark's
    trees: GPT-2 is handed in as ``gpt_params``; the mapper tree replaces the
    one the façade draws for itself."""
    from gpt2_image_captioning_tpu_torch import ImageCaptioningModel

    model = ImageCaptioningModel(port_configs(cfg), device=device, gpt_params=gpt)
    model.trainable = {"mapping": mp}
    model.drop_decode_caches()
    return model


def seeded_rng(seed: int, stream: int):
    """A numpy generator for one stream of the run's host-side draws."""
    import numpy as np

    return np.random.default_rng([seed % (2 ** 63), stream])


TRACE_SECONDS = 4.0  # the longest window a traced run measures


def window_seconds(cell: Cell) -> float:
    """The window's length: ``--seconds``, or at most TRACE_SECONDS when
    traced (the trace of a longer window would cost more to read than it
    tells)."""
    return min(cell.seconds, TRACE_SECONDS) if cell.trace else cell.seconds


@dataclass
class ReadContext:
    """What a per-layer reader (``metrics/<name>.py``: ``read(ctx)``) gets:
    the cell's configuration and traffic, the traced window and the
    harness's counts of the work done in it."""
    config: dict
    traffic: dict
    win: object
    counts: dict


def marker() -> None:
    """A marker kernel in the trace (a request's start)."""
    torch.cuda._sleep(100)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def release(device: torch.device) -> None:
    """Free what the program left behind before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def pace(what: str, t0: float, stamps: list[float]) -> str:
    """A line on how steady the window ran: ``what`` finished (host stamps
    after each) in each whole second of the window, and the longest wait
    between two."""
    if not stamps:
        return f"pace: no {what}"
    per_s = [0] * (int(stamps[-1] - t0) + 1)
    for t in stamps:
        per_s[int(t - t0)] += 1
    gaps = [b - a for a, b in zip([t0] + stamps, stamps)]
    return (f"pace: {what} in each second of the window {per_s}; longest wait "
            f"{max(gaps) * 1e3:.1f} ms, median {sorted(gaps)[len(gaps) // 2] * 1e3:.1f} ms")


def card_state(device: torch.device) -> str:
    """The card's clocks, temperature, power draw and throttle reasons, read
    once the window has closed."""
    if device.type != "cuda":
        return "card: no CUDA device"
    import subprocess

    query = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return f"card after the window ({query}): {out}"
