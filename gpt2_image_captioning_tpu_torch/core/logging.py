"""Scalar metrics, step timing and profiles — the counterpart of
``gpt2_image_captioning_tpu/core/logging.py``.

Every run writes an append-only ``metrics.jsonl`` (one ``{"tag", "value",
"step"}`` object a line, the JAX package's stream) and, where torch's
TensorBoard writer imports, TensorBoard events beside it.  ``profile_trace``
records a ``torch.profiler`` trace (the card's kernels too, when there is
one) and writes it as a Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch


class MetricsLogger:
    """Scalar logger: TensorBoard events (if torch's writer is importable)
    plus an always-on JSONL stream."""

    def __init__(self, log_dir: str = "logs"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Record a ``torch.profiler`` trace of the region (host ops, and the
    card's kernels and copies when CUDA is available) and write it to
    ``trace_dir/trace_<ms>.json`` (Chrome trace format, viewable in Perfetto)
    when ``trace_dir`` is set; no-op otherwise.  The card is synchronized
    before the trace closes, so the region's kernels are in it."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{int(time.time() * 1e3)}.json"))


class StepTimer:
    """Wall-clock per-step timing with warmup-aware summaries (host time of
    each step's dispatch: the step does not wait for the card)."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self, skip_warmup: int = 1) -> dict[str, Any]:
        ts = self.times[skip_warmup:] or self.times
        if not ts:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "mean_s": sum(ts) / len(ts),
            "min_s": min(ts),
            "max_s": max(ts),
        }
