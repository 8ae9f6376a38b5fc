"""launches_per_step.batch: kernels launched in the traced window (the
mapper's and the prefill's included) a decode step; decode steps are the
greedy vocabulary walk's launches, one a step."""

from h100_bench.metrics import trace


def read(ctx):
    steps = len(trace.kernels(ctx.win, "argmax_walk_kernel"))
    if not steps:
        return None
    return sum(e["cat"] == "kernel" for e in ctx.win.events) / steps
