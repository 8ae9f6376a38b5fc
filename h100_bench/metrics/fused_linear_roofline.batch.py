"""fused_linear_roofline.batch: the least time of every projection the
layers ran in the traced window (four a layer a decode step at the batch's
rows, four a layer a prefill at rows × prefix), each launch bounded by the
larger of its operations over the peak and its bytes over HBM's, over the
device time of ``csrc/fused_linear.cu``'s product kernel and the LayerNorm
pass it runs before the LN roles (``ln_rows_kernel``)."""

from h100_bench.metrics import flops, peaks, trace

KERNELS = ("linear_wgmma_kernel", "ln_rows_kernel")


def read(ctx):
    c, cfg = ctx.counts, ctx.config
    steps = len(trace.kernels(ctx.win, "argmax_walk_kernel"))
    device_s = trace.seconds(trace.kernels(ctx.win, *KERNELS))
    if not steps or device_s <= 0:
        return None
    dtype = "float32" if c["precision"] == "f32" else c["precision"]
    el = flops.BYTES[dtype]
    d, layers = cfg["gpt2"]["n_embd"], cfg["gpt2"]["n_layer"]
    p = cfg["mapping"]["prefix_length"]

    def layer_least(rows):
        return sum(peaks.least_seconds(*flops.linear(rows, k, n, el, el), dtype)
                   for k, n in flops.gpt2_layer_linears(d))

    least = layers * (steps * layer_least(c["rows"]) + c["requests"] * layer_least(c["rows"] * p))
    return 100.0 * least / device_s
