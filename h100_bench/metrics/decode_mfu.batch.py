"""decode_mfu.batch: the model's operations in the traced window (each
request's mapper, prefill and decode steps, counted from shapes) over the
window's seconds times the card's peak for the decode precision (float32:
the TF32 peak, each product counted once)."""

from h100_bench.metrics import flops, peaks


def read(ctx):
    c, win = ctx.counts, ctx.win
    if not c.get("requests") or win.window_s <= 0:
        return None
    per_request = c["decode_steps"] // c["requests"]
    ops = c["requests"] * flops.decode_request(ctx.config, c["rows"], per_request)
    dtype = "float32" if c["precision"] == "f32" else c["precision"]
    return 100.0 * ops / (win.window_s * peaks.ops_peak(dtype))
