"""vocab_roofline.batch: the least time of the greedy vocabulary walks in
the traced window (logits of every row against the tied embedding and their
argmax, one a decode step) over the device time of ``csrc/logits_argmax.cu``'s
walk and reduce kernels."""

from h100_bench.metrics import flops, peaks, trace


def read(ctx):
    c = ctx.counts
    walks = trace.kernels(ctx.win, "argmax_walk_kernel")
    device_s = trace.seconds(trace.kernels(ctx.win, "argmax_walk_kernel", "argmax_reduce_kernel"))
    if not walks or device_s <= 0:
        return None
    dtype = "float32" if c["precision"] == "f32" else c["precision"]
    least = len(walks) * peaks.least_seconds(*flops.vocab(c["rows"], ctx.config, dtype), dtype)
    return 100.0 * least / device_s
