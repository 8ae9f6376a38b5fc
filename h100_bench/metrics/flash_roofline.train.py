"""flash_roofline.train: the least time of the flash-attention forwards of
the traced window's steps (GPT-2's layers over prefix + caption, causal;
the mapper's layers over hidden + prefix tokens), q, k, v and o each moved
once, over the device time of ``csrc/flash_attention.cuh``'s kernel.  The
backward is torch operations and not counted."""

from h100_bench.metrics import flops, peaks, trace


def read(ctx):
    c, cfg, tr = ctx.counts, ctx.config, ctx.traffic
    device_s = trace.seconds(trace.kernels(ctx.win, "flash_attention_kernel"))
    if not c.get("steps") or device_s <= 0:
        return None
    dtype = "bf16" if tr["compute_dtype"] == "bfloat16" else "float32"
    g, m, b = cfg["gpt2"], cfg["mapping"], tr["batch"]
    t = m["prefix_length"] + tr["caption_length"]
    tm = m["prefix_length"] + m["hidden_length"]
    gpt = peaks.least_seconds(*flops.attention(b, g["n_head"], t, t, g["n_embd"] // g["n_head"],
                                               True, dtype), dtype)
    mapper = peaks.least_seconds(*flops.attention(b, m["num_heads"], tm, tm,
                                                  m["gpt_dim"] // m["num_heads"], False, dtype),
                                 dtype)
    least = c["steps"] * (g["n_layer"] * gpt + m["num_layers"] * mapper)
    return 100.0 * least / device_s
