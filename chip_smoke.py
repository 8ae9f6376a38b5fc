"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``gpt2_image_captioning_tpu_torch/csrc``,
holds each against its plain PyTorch twin at the main path's shapes, checks
that the kernels and the twins give the same greedy tokens on a tiny float32
model, then serves three requests of 128 image embeddings through
``ImageCaptioningModel.generate`` at GPT-2 124M width (random weights from a
seed, bf16, greedy, 50 tokens), showing through the kernels' launch counters
that the main path ran on them, and traces one more request with
``torch.profiler`` to read the decode loop's device idle share.  Each phase prints one JSON line; the last
three lines are the kernel table, the card's name and power limit, and
``{"ok": true, ...}``.  Any failed check raises, so the script exits non-zero
without the ``ok`` line.  Without a CUDA device it exits non-zero at once.
Longer output (nvcc's log, every phase's record) goes to ``chiprun_out/``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# Main-path shapes: GPT-2 124M, batch 128, 15 prefix + 50 tokens → Tpad 80.
B, D, H, T, V = 128, 768, 12, 80, 50257
ATTN_IDX = (0, 1, 15, 16, 17, 64)

# Tolerances, |kernel - plain| <= atol + rtol * |plain|.
# bf16 outputs: the kernel and the twin accumulate in float32 in different
# orders, which can move a result across a bf16 rounding boundary: one ulp,
# 2^-8 relative (0.4 %), so rtol 1e-2 with atol 1e-2 for values near 0.
# float32 residual-stream outputs and all float32 runs: only summation order
# differs, ~1e-6 relative over K <= 3072 terms, so 1e-4.
TOL = {
    torch.bfloat16: {"out": (1e-2, 1e-2), "f32": (1e-4, 1e-4), "gap": 1e-2},
    torch.float32: {"out": (1e-4, 1e-4), "f32": (1e-4, 1e-4), "gap": 1e-4},
}
# Teacher-forced check of the bf16 main path: every token the kernels chose
# must have a plain logit within TF_TOL of that step's plain max logit.
# Random-init logits have std ~0.55 (wte ~ N(0, 0.02) over 768 LN'd inputs);
# the two paths differ by bf16 rounding flips that compound over 12 layers and
# up to 49 steps of cache, measured below as the one-step drift on identical
# inputs.  0.05 is ~9 % of the logit std and several times the drift, yet far
# below the gap to a wrong token picked by a broken kernel (~1 logit std).
TF_TOL = 0.05

RESULTS: list[dict] = []


def emit(record: dict) -> None:
    RESULTS.append(record)
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def close(got: torch.Tensor, want: torch.Tensor, tol: tuple[float, float]) -> float:
    """Max |got - want|; raises unless within atol + rtol * |want| everywhere."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float(diff.max())
    check(bool((diff <= bound).all()), f"max |diff| {worst} exceeds atol {atol} + rtol {rtol}")
    return worst


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain twin
# ---------------------------------------------------------------------------

def check_attention(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA

    worst = 0.0
    for idx in ATTN_IDX:
        q, kn, vn = (torch.randn(B, D, generator=g, device="cuda").to(dtype) for _ in range(3))
        kc = torch.randn(T, B, D, generator=g, device="cuda").to(dtype)
        vc = torch.randn(T, B, D, generator=g, device="cuda").to(dtype)
        kc[idx:], vc[idx:] = 1e4, -1e4  # rows >= idx must never be attended
        kp, vp = kc.clone(), vc.clone()
        want = DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H)
        got = DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H)
        torch.cuda.synchronize()
        worst = max(worst, close(got, want, TOL[dtype]["out"]))
        check(torch.equal(kc, kp) and torch.equal(vc, vp), f"cache rows differ at idx {idx}")
    idx = max(ATTN_IDX)
    ms = time_ms(lambda: DA.decode_attention_cuda(q, kn, vn, kc, vc, idx, H))
    plain_ms = time_ms(lambda: DA._decode_attention_plain(q, kn, vn, kp, vp, idx, H))
    return {"kernel": "decode_attention", "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "at": f"B {B}, D {D}, H {H}, T {T}, idx {idx}"}


def check_dot_f32(g) -> dict:
    """The bf16 plain twins on the card multiply through ``ops/nn.py::dot_f32``'s
    CUDA branch (cuBLAS with a float32 output), while the CPU tests hold the
    upcast branch to the JAX package.  Both give exact bf16 products summed in
    float32, so they may differ only by summation order: ~1e-6 relative."""
    from gpt2_image_captioning_tpu_torch.ops import nn

    a = torch.randn(B, D, generator=g, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(D, 3 * D, generator=g, device="cuda")).to(torch.bfloat16)
    got = nn.dot_f32(a, w)
    want = torch.matmul(a.float(), w.float())
    return {"phase": "dot_f32_branches", "at": f"({B}, {D}) @ ({D}, {3 * D}) bf16",
            "max_abs_err": close(got, want, TOL[torch.float32]["f32"])}


LINEAR_ROLES = (  # name, K, N, LayerNorm prologue, epilogue
    ("qkv", D, 3 * D, True, "cast"),
    ("attn_proj", D, D, False, "residual"),
    ("mlp_fc", D, 4 * D, True, "gelu"),
    ("mlp_proj", 4 * D, D, False, "residual"),
)


def check_linear(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    worst, roles, ms_sum, plain_sum = 0.0, {}, 0.0, 0.0
    for name, k, n, ln, epi in LINEAR_ROLES:
        w = (0.02 * torch.randn(n, k, generator=g, device="cuda")).to(dtype)
        bias = 0.02 * torch.randn(n, generator=g, device="cuda")
        lnp = None
        if ln:
            x = 3.0 * torch.randn(B, k, generator=g, device="cuda")
            lnp = (1 + 0.1 * torch.randn(k, generator=g, device="cuda"),
                   0.1 * torch.randn(k, generator=g, device="cuda"))
        else:
            x = torch.randn(B, k, generator=g, device="cuda").to(dtype)
        res = torch.randn(B, n, generator=g, device="cuda") if epi == "residual" else None
        kw = dict(epilogue=epi, ln=lnp)
        r_plain, r_kernel = (None, None) if res is None else (res.clone(), res.clone())
        want = DS.fused_linear_plain(x, w, bias, residual=r_plain, **kw)
        got = DS.fused_linear_cuda(x, w, bias, residual=r_kernel, **kw)
        torch.cuda.synchronize()
        err = close(got, want, TOL[dtype]["f32" if epi == "residual" else "out"])
        worst = max(worst, err)
        ms = time_ms(lambda: DS.fused_linear_cuda(x, w, bias, residual=r_kernel, **kw))
        plain_ms = time_ms(lambda: DS.fused_linear_plain(x, w, bias, residual=r_plain, **kw))
        roles[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        ms_sum += ms
        plain_sum += plain_ms
    return {"kernel": "fused_linear", "max_abs_err": worst, "ms": ms_sum, "plain_ms": plain_sum,
            "at": f"B {B}: the four projections of one layer, summed", "roles": roles}


def check_logits_argmax(dtype, g) -> dict:
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    x32 = 3.0 * torch.randn(B, D, generator=g, device="cuda")
    lnf = torch.stack([1 + 0.1 * torch.randn(D, generator=g, device="cuda"),
                       0.1 * torch.randn(D, generator=g, device="cuda")]).contiguous()
    wte = (0.02 * torch.randn(V, D, generator=g, device="cuda")).to(dtype)
    logits = DS.logits_plain(x32, lnf, wte)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    got = DS.logits_argmax_cuda(x32, lnf, wte)
    torch.cuda.synchronize()
    top2 = logits.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL[dtype]["gap"]
    check(bool((got == want)[clear].all()), "argmax differs on a row with a clear top-2 gap")
    deficit = top2[:, 0] - logits.gather(1, got.long()[:, None])[:, 0]
    err = float(deficit.max())
    check(err <= TOL[dtype]["gap"], f"a chosen token's logit is {err} below the row max")
    # forced ties: copy row 0's winner into a lower id — id 0, in another
    # 32-column tile of the kernel, and the id just below it
    win = int(want[0])
    check(win > 0, "row 0's winner is id 0; change the seed")
    ties = {}
    for low in sorted({0, win - 1}):
        w2 = wte.clone()
        w2[low] = wte[win]
        tok = DS.logits_argmax_cuda(x32, lnf, w2)
        plain = DS.logits_argmax_plain(x32, lnf, w2)
        check(int(tok[0]) == low, f"tie between ids {low} and {win} picked {int(tok[0])}")
        ties[f"{low}={win}"] = {"kernel": int(tok[0]), "plain": int(plain[0])}
    ms = time_ms(lambda: DS.logits_argmax_cuda(x32, lnf, wte))
    plain_ms = time_ms(lambda: DS.logits_argmax_plain(x32, lnf, wte))
    return {"kernel": "logits_argmax", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "at": f"B {B}, D {D}, V {V}", "rows_with_clear_gap": int(clear.sum()), "ties": ties}


# ---------------------------------------------------------------------------
# Phases 4 and 5: generate
# ---------------------------------------------------------------------------

def decode_steps(tokens: torch.Tensor, eos: int) -> int:
    """Decode steps generate ran for this output: it stops once every row has
    emitted EOS, or after max_length - 1 steps."""
    b, max_length = tokens.shape
    is_eos = (tokens == eos).cpu().numpy()
    first = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), max_length)
    return int(min(first.max(), max_length - 1))


def check_padding(tokens: torch.Tensor, eos: int, vocab: int) -> int:
    """Every row is EOS after its first EOS; returns the number of rows that
    finished before the last position."""
    t = tokens.cpu().numpy()
    check(t.dtype == np.int32 and ((t >= 0) & (t < vocab)).all(), "token ids out of range")
    finished = 0
    for row in t:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            check(bool((row[hits[0]:] == eos).all()), "a row is not EOS-padded after its EOS")
            finished += int(hits[0] < len(row) - 1)
    return finished


def tiny_exact_tokens() -> dict:
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models.gpt2 import GPT2Config
    from gpt2_image_captioning_tpu_torch.models.mapping import MLPMappingConfig

    gcfg = GPT2Config.tiny()  # n_embd 32, 2 layers, 2 heads, vocab 293
    cfg = C.CaptionerConfig(gpt2=gcfg, mapping=MLPMappingConfig(prefix_length=4, embed_dim=16,
                                                                 gpt_dim=32))
    tr, fz = C.init_params(torch.Generator().manual_seed(7), cfg, device="cuda")
    emb = torch.from_numpy(np.random.default_rng(5).normal(size=(5, 16)).astype(np.float32))
    emb = emb.cuda()
    kw = dict(max_length=12, temperature=0.0)
    probe = C.generate(tr, fz, cfg, emb, use_kernels=False, **kw).cpu().numpy()
    # EOS := a token row 0 emits after its first, absent from the first
    # column, so some rows stop early and get padded while others run on
    firsts = set(probe[:, 0].tolist())
    eos = next((int(t) for t in probe[0, 1:] if int(t) not in firsts), int(probe[0, 1]))
    cfg = dataclasses.replace(cfg, eos_token_id=eos)
    want = C.generate(tr, fz, cfg, emb, use_kernels=False, **kw)
    got = C.generate(tr, fz, cfg, emb, use_kernels=True, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"tiny f32 tokens differ:\n{got.cpu()}\n{want.cpu()}")
    return {"phase": "tiny_f32_exact_tokens", "eos": eos, "tokens_equal": True,
            "rows_finished_early": check_padding(got, eos, gcfg.vocab_size),
            "decode_steps": decode_steps(got, eos), "batch": 5, "max_length": 12}


def teacher_forced(model, emb: torch.Tensor, tokens: torch.Tensor) -> tuple[float, int, float]:
    """Feed the kernel path's tokens through the plain path step by step.
    Returns (worst deficit of a chosen token's plain logit below the plain max,
    tokens checked, share of them that are the plain argmax)."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    cfg = model.cfg
    tr, fz, pol = model.decode_params("bf16")
    gpt = C._gpt(tr, fz)
    packed = C.prepare_decode_weights(tr, fz, cfg, pol)
    eos, eps = cfg.eos_token_id, cfg.gpt2.layer_norm_epsilon
    prefix = C.build_prefix(tr, cfg, emb, pol)
    b, p_len, _ = prefix.shape
    cache = G.init_cache(cfg.gpt2, b, p_len + tokens.shape[1], dtype=pol.compute_dtype,
                         device="cuda")
    logits, cache = G.forward_cached(gpt, cfg.gpt2, prefix, cache, pol)
    alive = torch.ones(b, dtype=torch.bool, device="cuda")
    worst, n, agree, idx = 0.0, 0, 0, cache["index"]
    for s in range(tokens.shape[1]):
        if s > 0:
            x0 = (gpt["wte"][tokens[:, s - 1].long()] + gpt["wpe"][idx]).to(pol.compute_dtype)
            x32 = DS.decode_layers(packed, x0, cache["k"], cache["v"], idx,
                                   n_head=cfg.gpt2.n_head, eps=eps, use_kernels=False)
            logits = DS.logits_plain(x32, packed["lnf"], packed["wte"], eps)
            idx += 1
        chosen = logits.gather(1, tokens[:, s].long()[:, None])[:, 0]
        deficit = (logits.max(dim=-1).values - chosen)[alive]
        worst = max(worst, float(deficit.max()))
        agree += int((deficit == 0).sum())
        n += int(alive.sum())
        alive &= tokens[:, s] != eos
        if not bool(alive.any()):
            break
    return worst, n, agree / n


def one_step_drift(model, emb: torch.Tensor) -> float:
    """Max |logit| difference of one decode step run by the kernels and by
    the plain twins from the same prefilled cache and input."""
    from gpt2_image_captioning_tpu_torch.models import captioner as C
    from gpt2_image_captioning_tpu_torch.models import gpt2 as G
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    cfg = model.cfg
    tr, fz, pol = model.decode_params("bf16")
    gpt = C._gpt(tr, fz)
    packed = C.prepare_decode_weights(tr, fz, cfg, pol)
    prefix = C.build_prefix(tr, cfg, emb, pol)
    cache = G.init_cache(cfg.gpt2, prefix.shape[0], prefix.shape[1] + 50,
                         dtype=pol.compute_dtype, device="cuda")
    logits, cache = G.forward_cached(gpt, cfg.gpt2, prefix, cache, pol)
    idx = cache["index"]
    x0 = (gpt["wte"][logits.argmax(-1)] + gpt["wpe"][idx]).to(pol.compute_dtype)
    out = []
    for use in (True, False):
        k, v = cache["k"].clone(), cache["v"].clone()
        x32 = DS.decode_layers(packed, x0, k, v, idx, n_head=cfg.gpt2.n_head,
                               eps=cfg.gpt2.layer_norm_epsilon, use_kernels=use)
        out.append(DS.logits_plain(x32, packed["lnf"], packed["wte"]))
    return float((out[0] - out[1]).abs().max())


# the port's kernels by their CUDA function names (csrc/*.cu)
PORT_KERNELS = ("fused_linear_kernel", "ln_stats_kernel", "decode_attention_kernel",
                "ln_rows_kernel", "logits_tile_kernel", "argmax_reduce_kernel")


def profile_request(model, req: np.ndarray, kw: dict, steps: int) -> dict:
    """Trace one request with ``torch.profiler`` (CUDA activity only) and read
    the decode loop from that one trace: its window on the device runs from
    the first launch of the port's kernels to the end of the last, and its
    busy time is the union of every kernel, copy and memset in the window
    (the port's kernels and the torch ops between them)."""
    from torch.profiler import ProfilerActivity, profile

    trace = OUT_DIR / "decode_trace.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(req, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]

    def is_port(e):
        return e["cat"] == "kernel" and any(k in e["name"] for k in PORT_KERNELS)

    ours = [e for e in events if is_port(e)]
    record = {"phase": "decode_profile", "profiled_request_s": wall, "trace": trace.name,
              "device_events": len(events)}
    if not ours:  # CUPTI gave no device activity: nothing to read
        return {**record, "idle_share": "not measured"}
    lo = min(e["ts"] for e in ours)
    hi = max(e["ts"] + e["dur"] for e in ours)
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                   if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    in_window = [e for e in events if lo <= e["ts"] < hi]
    window_s, busy_s = (hi - lo) * 1e-6, busy * 1e-6
    return {**record, "decode_steps": steps, "decode_window_s": window_s,
            "device_busy_s": busy_s, "idle_share": 1.0 - busy_s / window_s,
            "port_kernels_s": sum(e["dur"] for e in ours) * 1e-6,
            "other_kernels_s": sum(e["dur"] for e in in_window
                                   if e["cat"] == "kernel" and not is_port(e)) * 1e-6,
            "copies_s": sum(e["dur"] for e in in_window if e["cat"] != "kernel") * 1e-6,
            "events_in_window": len(in_window), "card": nvidia_smi()}


def decode_window(model, req: np.ndarray, kw: dict) -> float:
    """Seconds on the device from the start of the first decode step to the end
    of the last, in one request run without the profiler: CUDA events recorded
    around each ``fused_decode_step`` call (two event records per step)."""
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    step, marks = DS.fused_decode_step, []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    DS.fused_decode_step = timed
    try:
        model.generate(req, **kw)
    finally:
        DS.fused_decode_step = step
    torch.cuda.synchronize()
    return marks[0][0].elapsed_time(marks[-1][1]) * 1e-3


def main_path() -> tuple[dict, dict, dict]:
    from gpt2_image_captioning_tpu_torch import (
        CaptionerConfig, GPT2Config, ImageCaptioningModel, TransformerMappingConfig,
    )
    from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
    from gpt2_image_captioning_tpu_torch.ops import decode_step as DS

    cfg = CaptionerConfig(gpt2=GPT2Config.gpt2_124m(),
                          mapping=TransformerMappingConfig(512, 768, 15, 10))
    model = ImageCaptioningModel(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    reqs = [rng.normal(size=(B, 512)).astype(np.float32) for _ in range(3)]
    kw = dict(max_length=50, temperature=0.0, decode_precision="bf16")
    model.generate(reqs[0], **kw)  # warm-up: bf16 weight copy, packing, first launches
    torch.cuda.synchronize()

    wrappers = {"decode_attention": DA.decode_attention_cuda,
                "fused_linear": DS.fused_linear_cuda,
                "logits_argmax": DS.logits_argmax_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [model.generate(r, **kw) for r in reqs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}

    steps = sum(decode_steps(o, cfg.eos_token_id) for o in outs)
    n_layer = cfg.gpt2.n_layer
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(launches["decode_attention"] == n_layer * steps,
          f"attention launches {launches['decode_attention']} != {n_layer} x {steps} steps")
    check(launches["fused_linear"] == 4 * n_layer * steps, "fused_linear launches != 4 L steps")
    check(launches["logits_argmax"] == steps, "logits_argmax launches != steps")
    for o in outs:
        check(tuple(o.shape) == (B, 50) and o.dtype == torch.int32, f"bad output {o.shape}")
        check_padding(o, cfg.eos_token_id, cfg.gpt2.vocab_size)

    t0 = time.perf_counter()
    plain = [model.generate(r, use_kernels=False, **kw) for r in reqs]
    torch.cuda.synchronize()
    plain_seconds = time.perf_counter() - t0
    same = sum(int((a == b).all(dim=1).sum()) for a, b in zip(outs, plain))

    drift = one_step_drift(model, torch.from_numpy(reqs[0]).cuda())
    worst, checked, agree = 0.0, 0, 0.0
    for r, o in zip(reqs, outs):
        w, n, a = teacher_forced(model, torch.from_numpy(r).cuda(), o)
        worst, checked, agree = max(worst, w), checked + n, agree + a * n
    check(worst <= TF_TOL, f"teacher-forced: a chosen token is {worst} below the plain max "
                           f"(tolerance {TF_TOL})")
    record = {
        "phase": "main_path", "model": "GPT-2 124M + transformer mapper (512->768, 15+10)",
        "dtype": "bf16", "requests": len(reqs), "batch": B, "max_length": 50,
        "decode_steps": steps, "launches": launches,
        "img_per_s_kernels": len(reqs) * B / seconds, "seconds_kernels": seconds,
        "img_per_s_plain": len(reqs) * B / plain_seconds, "seconds_plain": plain_seconds,
        "rows_identical_to_plain": same, "rows": len(reqs) * B,
        "one_step_logit_drift": drift,
        "teacher_forced": {"worst_deficit": worst, "tolerance": TF_TOL, "tokens_checked": checked,
                           "share_plain_argmax": agree / checked},
        "card": nvidia_smi(),
    }
    profiled = profile_request(model, reqs[0], kw, decode_steps(outs[0], cfg.eos_token_id))
    profiled["unprofiled_request_s"] = seconds / len(reqs)
    if "device_busy_s" in profiled:
        # the traced request's busy time against another request's window: the
        # tracer slows the host, which stretches the window but not the kernels
        window = decode_window(model, reqs[0], kw)
        profiled["unprofiled_decode_window_s"] = window
        profiled["idle_share_est_unprofiled"] = 1.0 - profiled["device_busy_s"] / window
    return record, launches, profiled


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from gpt2_image_captioning_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in full float32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": str(lib_path.name),
          "key": lib_path.parent.name})
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc.log").write_text((lib_path.parent / "nvcc.log").read_text())

    g = torch.Generator(device="cuda").manual_seed(0)
    emit(check_dot_f32(g))
    kernel_rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for fn in (check_attention, check_linear, check_logits_argmax):
            rec = fn(dtype, g)
            rec = {"phase": "kernel_vs_plain", "dtype": str(dtype).replace("torch.", ""), **rec}
            emit(rec)
            if dtype == torch.bfloat16:
                kernel_rows[rec["kernel"]] = rec

    emit(tiny_exact_tokens())
    record, launches, profiled = main_path()
    emit(record)
    emit(profiled)

    source = "gpt2_image_captioning_tpu_torch/csrc/"
    replaces = {"decode_attention": "gpt2_image_captioning_tpu/ops/decode_attention.py:68",
                "fused_linear": "gpt2_image_captioning_tpu/ops/decode_step.py:112",
                "logits_argmax": "gpt2_image_captioning_tpu/ops/decode_step.py:112"}
    # what one "ms" covers, and what one count of "launches" is: a wrapper call
    per = {"decode_attention": "call (1 CUDA launch), idx 64",
           "fused_linear": "layer: 4 calls (qkv, attn_proj, mlp_fc, mlp_proj; 6 CUDA launches)",
           "logits_argmax": "call (3 CUDA launches)"}
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{source}{name}.cu", "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": kernel_rows[name]["max_abs_err"],
         "ms": kernel_rows[name]["ms"], "plain_ms": kernel_rows[name]["plain_ms"],
         "per": per[name]}
        for name in ("decode_attention", "fused_linear", "logits_argmax")
    ]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(RESULTS + [table], indent=1))
    print(json.dumps(table), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
