"""prefill_ms.batch: device milliseconds a request spends before its first
decode step: the kernels from the request's marker to its first decode
attention (the mapper, the prefill, the first token's selection, and the
first step's LayerNorm and qkv projection), averaged over the traced
requests."""

from h100_bench.metrics import trace


def read(ctx):
    win = ctx.win
    if not win.markers:
        return None
    bounds = list(win.markers) + [float("inf")]
    per = []
    for lo, hi in zip(bounds, bounds[1:]):
        mine = [e for e in win.events if lo <= e["ts"] < hi]
        first = next((e["ts"] for e in mine if "decode_attention_kernel" in e["name"]), None)
        if first is None:
            continue
        per.append(trace.seconds([e for e in mine if e["ts"] < first and e["cat"] == "kernel"]))
    return 1e3 * sum(per) / len(per) if per else None
