"""train_mfu.train: the train step's operations (GPT-2's forward and
activation gradients with no weight gradients, the loss's logits and their
gradient, the mapper's 6·N·tokens; ``flops.train_step``) of every step in
the traced window, over its seconds times the card's peak for the compute
dtype."""

from h100_bench.metrics import flops, peaks


def read(ctx):
    c, tr = ctx.counts, ctx.traffic
    if not c.get("steps") or ctx.win.window_s <= 0:
        return None
    dtype = "bf16" if tr["compute_dtype"] == "bfloat16" else "float32"
    ops = c["steps"] * flops.train_step(ctx.config, tr["batch"], tr["caption_length"])
    return 100.0 * ops / (ctx.win.window_s * peaks.ops_peak(dtype))
