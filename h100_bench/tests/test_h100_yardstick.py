"""The yardstick's arithmetic against hand-worked shapes, and the trace
reading on synthetic events."""

import math

import pytest

from h100_bench.metrics import flops, peaks, trace
from h100_bench.tests import tiny

GPT2_124M = {"gpt2": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
                      "n_head": 12, "layer_norm_epsilon": 1e-5},
             "mapping": {"embed_dim": 512, "gpt_dim": 768, "prefix_length": 15,
                         "hidden_length": 10, "num_layers": 8, "num_heads": 8},
             "vision": {"image_size": 224, "patch_size": 32, "hidden_size": 768,
                        "intermediate_size": 3072, "num_hidden_layers": 12,
                        "num_attention_heads": 12, "projection_dim": 512}}


def test_one_gpt2_124m_layer_at_512_rows():
    # qkv 768x2304, proj 768x768, fc 768x3072, fc proj 3072x768: 12 · 768² weights
    ops, nbytes = 0.0, 0.0
    for k, n in flops.gpt2_layer_linears(768):
        o, b = flops.linear(512, k, n, 4, 4)
        ops, nbytes = ops + o, nbytes + b
    assert ops == 2 * 512 * 12 * 768 * 768 == 7_247_757_312
    weights = 12 * 768 * 768 * 4
    acts = 512 * 4 * (768 + 2304 + 768 + 768 + 768 + 3072 + 3072 + 768)
    biases = 4 * (2304 + 768 + 3072 + 768)
    assert nbytes == weights + acts + biases
    all_layers = flops.linears_of_rows(GPT2_124M, 512, "float32")
    assert all_layers == (12 * ops, 12 * nbytes)


def test_bound_picks_the_larger_time():
    # a 512-row float32 layer: 7.25 GFLOP at 495 TFLOP/s take 14.6 us; its
    # 53.5 MB (28.3 MB of weights) at 3.35 TB/s take 16.0 us: the bytes bound it
    ops, nbytes = flops.linears_of_rows(GPT2_124M, 512, "float32")
    per_layer = (ops / 12, nbytes / 12)
    # in: 768 + 768 + 768 + 3072 columns; out: 2304 + 768 + 3072 + 768
    assert per_layer[1] == 12 * 768 * 768 * 4 + 512 * 4 * (5376 + 6912) + 4 * 6912 == 53_505_024
    t = peaks.least_seconds(*per_layer, "float32")
    assert t == pytest.approx(per_layer[1] / 3.35e12) == pytest.approx(15.971e-6, rel=1e-4)
    # in bf16 at 2,048 rows (a prefill's) they are bound by their operations
    bf = flops.linears_of_rows(GPT2_124M, 2048, "bf16")
    assert peaks.least_seconds(bf[0] / 12, bf[1] / 12, "bf16") == pytest.approx(
        bf[0] / 12 / 989e12)


def test_decode_step_and_vocab():
    # 24·B·D² a layer, 4·B·t·D of attention, 2·B·D·V of logits
    got = flops.decode_step(GPT2_124M, 512, 20)
    assert got == 12 * (24 * 512 * 768 ** 2 + 4 * 512 * 20 * 768) + 2 * 512 * 768 * 50257
    ops, nbytes = flops.vocab(512, GPT2_124M, "bf16")
    assert ops == 2 * 512 * 768 * 50257
    assert nbytes == 50257 * 768 * 2 + 512 * 768 * 4 + 512 * 4


def test_causal_attention_counts_kept_pairs():
    assert flops.attention_ops(1, 1, 3, 3, 8, causal=True) == 4 * 8 * (1 + 2 + 3)
    assert flops.attention_ops(2, 4, 3, 5, 8, causal=False) == 4 * 8 * 2 * 4 * 15
    # a causal tail after 4 cached keys: rows see 5, 6 and 7 keys
    assert flops.attention_ops(1, 1, 3, 7, 8, causal=True, q_offset=4) == 4 * 8 * 18


def test_patch_embed_counts():
    ops, nbytes = flops.patch_embed(GPT2_124M, 256, "bf16")
    assert ops == 2 * 256 * 49 * 3072 * 768
    assert nbytes == 256 * 224 * 224 * 3 + 3072 * 768 * 2 + 256 * 49 * 768 * 4


def test_train_step_counts():
    # frozen GPT-2: forward + activation gradients of every product (2x),
    # attention 3x, the loss's logits and their gradient (2x); mapper 3x forward
    b, cap = 128, 50
    t = 15 + cap
    products = 12 * 24 * b * t * 768 ** 2
    attn = 12 * 4 * 768 * b * t * (t + 1) / 2
    head = 2 * b * cap * 768 * 50257
    want = 2 * products + 3 * attn + 2 * head + 3 * flops.mapper(GPT2_124M, b)
    assert flops.train_step(GPT2_124M, b, cap) == pytest.approx(want)
    assert 4.9e12 < want < 5.0e12


def test_float32_peak_is_tf32_counted_once():
    assert peaks.ops_peak("float32") == 495e12
    assert peaks.ops_peak("bf16") == 989e12
    assert peaks.HBM_BYTES_S == 3.35e12


def ev(name, ts, dur, cat="kernel", corr=0):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur), "corr": corr}


def test_busy_is_the_union_of_events():
    events = [ev("a", 0, 10), ev("b", 5, 10), ev("c", 30, 5)]
    assert trace.busy_us(events, 0, 40) == 20
    assert trace.busy_us(events, 8, 32) == 9


class FakeEvent:
    def __init__(self, name, cat, ts_us, dur_us, corr):
        self._v = (name, cat, ts_us, dur_us, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1e3)

    def duration_ns(self):
        return int(self._v[3] * 1e3)

    def correlation_id(self):
        return self._v[4]


def test_read_events_window_markers_and_gaps():
    raw = [FakeEvent("void at::native::(anonymous)::spin_kernel(long)", "kernel", 0, 100, 1),
           FakeEvent("cudaDeviceSynchronize", "cuda_runtime", 50, 60, 2),
           FakeEvent("cudaLaunchKernel", "cuda_runtime", 150, 5, 3),
           FakeEvent("void linear_wgmma_kernel<float, float, 64>(Args)", "kernel", 200, 50, 3),
           FakeEvent("void at::native::(anonymous)::spin_kernel(long)", "kernel", 260, 1, 4),
           FakeEvent("cudaStreamSynchronize", "cuda_runtime", 255, 40, 5),
           FakeEvent("Memcpy HtoD", "gpu_memcpy", 300, 10, 6),
           FakeEvent("cudaLaunchKernel", "cuda_runtime", 320, 5, 7)]  # its kernel was lost
    win = trace.read_events(raw)
    assert [e["name"] for e in win.events] == ["void linear_wgmma_kernel<float, float, 64>(Args)",
                                               "Memcpy HtoD"]
    assert win.markers == [260.0]
    assert win.window_s == pytest.approx(110e-6)
    assert win.busy_s == pytest.approx(60e-6)
    assert win.dropped == 1
    assert trace.device_ops(win)[0] == ["linear_wgmma_kernel<float, float, 64>",
                                        pytest.approx(50e-6)]
    gaps = trace.idle_gaps(win)
    assert gaps == [["cudaStreamSynchronize -> Memcpy HtoD", pytest.approx(50e-6)]]


def test_readers_return_nothing_without_a_trace():
    import importlib.util

    from h100_bench import harness as H

    empty = H.ReadContext(tiny.CONFIG, tiny.TRAFFIC["batch"], trace.Window([], [], [], 0), {})
    for path in sorted((H.BENCH_DIR / "metrics").glob("*.*.py")):
        spec = importlib.util.spec_from_file_location("reader", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read(empty) is None, path.name


def test_batch_readers_on_a_synthetic_window():
    from h100_bench import harness as H
    from h100_bench.run import read_metric

    cfg = GPT2_124M
    steps, rows = 2, 512
    events, t = [], 0.0
    for _ in range(steps):
        for name, dur in (("linear_wgmma_kernel<float,float,64>", 60.0),
                          ("decode_attention_kernel", 10.0), ("argmax_walk_kernel", 300.0),
                          ("argmax_reduce_kernel", 5.0)):
            events.append(ev(name, t, dur))
            t += dur + 5.0
    win = trace.Window(events, [], [], 0, lo=0.0, hi=t, window_s=t * 1e-6,
                       busy_s=sum(e["dur"] for e in events) * 1e-6)
    ctx = H.ReadContext(cfg, {}, win, {"requests": 1, "rows": rows, "decode_steps": steps,
                                       "precision": "f32"})
    vocab = read_metric("vocab_roofline.batch", ctx)
    least = steps * peaks.least_seconds(*flops.vocab(rows, cfg, "float32"), "float32")
    assert vocab == pytest.approx(100 * least / (steps * 305e-6))
    assert read_metric("launches_per_step.batch", ctx) == 4
    idle = read_metric("idle_share.batch", ctx)
    assert idle == pytest.approx(100 * 5 * 8 / t)
    mfu = read_metric("decode_mfu.batch", ctx)
    assert math.isfinite(mfu) and mfu > 0
