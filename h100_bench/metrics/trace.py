"""The device trace of a window: ``torch.profiler`` with CUDA activity only,
read from the profiler's own event list (no file is written).

A copy of the port's first tracing code (``chip_smoke.py``: ``traced``,
``busy_us`` and the window of ``profile_request``), kept here so that later
changes to the program cannot change how it is measured:

- CUPTI can lose the first device records of a window while it fetches its
  first activity buffer, so the window opens with a marker kernel
  (``torch.cuda._sleep``) and a pause; launches whose device record is
  missing are counted (``dropped``).
- The device window runs from the first device event after the marker to the
  end of the last; busy time is the union of every kernel, copy and memset
  in it.

Marker kernels (``torch.cuda._sleep``, "spin_kernel" in the trace) that the
harness launches inside the window to mark a boundary are returned apart, as
``markers``, and take no part in busy time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Window:
    """What a traced window holds: device events (``name``, ``cat``, ``ts``
    and ``dur`` in µs), host CUDA API events, marker times, and the window."""
    events: list[dict]
    host: list[dict]
    markers: list[float]
    dropped: int
    lo: float = 0.0
    hi: float = 0.0
    busy_s: float = 0.0
    window_s: float = 0.0


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def busy_us(events: list[dict], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi) covered by at least one device event."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                   if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class Tracer:
    """``start()`` before the traced work, ``stop()`` after it (which
    synchronises) → a :class:`Window`."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        time.sleep(0.02)

    def stop(self) -> Window:
        import torch

        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        return read_events(prof.profiler.kineto_results.events())


def category(e) -> str:
    """A kineto event's kind, as the chrome trace names it ("kernel",
    "gpu_memcpy", "gpu_memset", "cuda_runtime", ...): its activity type
    where the event has one, else from its device and name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    name = e.name()
    if "CUDA" in str(e.device_type()):
        low = name.lower()
        return "gpu_memcpy" if "memcpy" in low else "gpu_memset" if "memset" in low else "kernel"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def read_events(raw) -> Window:
    """A :class:`Window` from the profiler's kineto events."""
    device, host = [], []
    for e in raw:
        cat = category(e)
        rec = {"name": e.name(), "cat": cat, "ts": e.start_ns() / 1e3,
               "dur": e.duration_ns() / 1e3, "corr": e.correlation_id()}
        if cat in DEVICE_CATS:
            device.append(rec)
        elif cat in HOST_CATS:
            host.append(rec)
    device.sort(key=lambda e: e["ts"])
    host.sort(key=lambda e: e["ts"])
    spins = [e for e in device if MARKER in e["name"]]
    opened = spins[0]["ts"] + spins[0]["dur"] if spins else float("-inf")
    markers = [e["ts"] for e in spins[1:]]
    events = [e for e in device if MARKER not in e["name"] and e["ts"] >= opened]
    seen = {e["corr"] for e in device}
    first_sync = min((h["ts"] for h in host if "Synchronize" in h["name"]), default=float("-inf"))
    dropped = sum(h["corr"] not in seen for h in host if h["ts"] > first_sync
                  and any(w in h["name"] for w in ("Launch", "Memcpy", "Memset")))
    win = Window(events, host, markers, dropped)
    if events:
        win.lo = events[0]["ts"]
        win.hi = max(e["ts"] + e["dur"] for e in events)
        win.window_s = (win.hi - win.lo) * 1e-6
        win.busy_s = busy_us(events, win.lo, win.hi) * 1e-6
    return win


def kernels(win: Window, *names: str) -> list[dict]:
    """The window's kernel events whose name holds one of ``names``."""
    return [e for e in win.events if e["cat"] == "kernel" and any(n in e["name"] for n in names)]


def seconds(events: list[dict]) -> float:
    return sum(e["dur"] for e in events) * 1e-6


def device_ops(win: Window, top: int = 10) -> list[list]:
    """The device operations that took most time: [short name, seconds]."""
    by: dict[str, float] = {}
    for e in win.events:
        n = short_name(e["name"])[:120]
        by[n] = by.get(n, 0.0) + e["dur"] * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(win: Window, top: int = 10) -> list[list]:
    """The device's idle time in the window, summed by what the host was
    doing then (the CUDA API call that overlaps the gap most, or none) and
    the kernel the device waited for: [label, seconds], longest first."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in win.events)
    gaps, end = [], win.lo
    for a, b, name in spans:
        if a > end:
            gaps.append((end, a, name))
        end = max(end, b)
    host = win.host
    by: dict[str, float] = {}
    j = 0
    for a, b, nxt in gaps:
        while j < len(host) and host[j]["ts"] + host[j]["dur"] < a:
            j += 1
        best, call = 0.0, "host, no CUDA call"
        k = j
        while k < len(host) and host[k]["ts"] < b:
            h = host[k]
            over = min(b, h["ts"] + h["dur"]) - max(a, h["ts"])
            if over > best:
                best, call = over, h["name"]
            k += 1
        label = f"{call} -> {short_name(nxt)[:60]}"
        by[label] = by.get(label, 0.0) + (b - a) * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
