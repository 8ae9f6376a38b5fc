"""The GPT-2 decode step — the counterpart of
``gpt2_image_captioning_tpu/ops/decode_step.py`` in its greedy,
``emit_logits``, ``topk``, beam-ancestry, per-row ``start`` and in-kernel
``sample`` modes.

On the TPU the whole step is one Pallas kernel (``_step_kernel``), because
each kernel call there carries a large fixed cost.  Blocks on Hopper cannot
synchronise across layers without a grid-wide barrier, so the port runs the
step as a short sequence of hand-written kernels, five calls per layer and one
for the vocabulary:

- ``csrc/fused_linear.cu`` — ``y = epilogue(prologue(x) @ W + b)``: the QKV
  projection (LN1 prologue), the attention output projection (residual-add
  epilogue), the MLP up-projection (LN2 prologue, gelu_new epilogue) and its
  down-projection (residual add);
- ``csrc/decode_attention.cu`` (via :mod:`ops.decode_attention`) — the cache
  append and the valid-prefix attention, optionally through the beam
  ancestry map ``origin`` or over per-row windows ``[start_r, idx]``
  (continuous batching);
- the vocabulary, by mode: ``csrc/logits_argmax.cu`` (greedy: the final LN,
  the tied-embedding logits and the argmax, without storing the (B, V)
  logits), ``csrc/logits.cu`` (``emit_logits``: the float32 logits stored,
  for the sampling tail), ``csrc/logits_topk.cu`` (``topk``: each row's
  top-k and logsumexp, for beam search) or ``csrc/logits_sample.cu``
  (``sample``: a per-row temperature / top-p draw by speculative accept,
  the logits never stored).

Numerics follow ``_step_kernel``: inputs in the compute dtype, float32
accumulation, float32 LayerNorm and softmax statistics, a float32 residual
stream to which the projections are added unrounded, and ties to the
smallest token id.  Every kernel has a plain PyTorch twin in this module (or
in ``ops/decode_attention.py``) with the same arithmetic; the CPU runs the
twins, and ``use_kernels=False`` runs them on the card for comparison.

Not ported: int8 weights and the int8 KV cache (ROADMAP.md, queue 2,
item 2, modes 3 and 7).
"""

from __future__ import annotations

import torch

from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.decode_attention import decode_attention
from gpt2_image_captioning_tpu_torch.ops.sampling import sample_step_plain, topk_small

# epilogue codes of csrc/fused_linear.cu
EPILOGUES = {"cast": 0, "gelu": 1, "residual": 2}


def fused_greedy_enabled(use_kernels: bool | None, device) -> bool:
    """Whether decoding on ``device`` runs the CUDA kernels (True) or their
    plain twins (False), in every mode of the step.  Unlike the JAX package
    there is no width, dtype or beam-block gate: on CUDA the kernels run in
    bf16 and float32 at any width, batch and beam size."""
    return _build.kernels_enabled(use_kernels, device)


def pack_decode_weights(params: dict, compute_dtype: torch.dtype = torch.bfloat16) -> dict:
    """One-time re-layout of the stacked GPT-2 params for the step kernels.

    The kernels read every weight output-major, (N, K) with each output
    column's K weights contiguous — the layout the tied embedding already has.
    So the (L, in, out) ``Conv1D`` matrices are transposed once to
    (L, out, in) in the compute dtype; wte stays (V, D).  LayerNorm params and
    biases are float32.
    """
    blocks = params["blocks"]

    def mat(w):
        return w.to(compute_dtype).transpose(1, 2).contiguous()

    def f32(t):
        return t.to(torch.float32).contiguous()

    return {
        "ln1s": f32(blocks["ln_1"]["scale"]),
        "ln1b": f32(blocks["ln_1"]["bias"]),
        "ln2s": f32(blocks["ln_2"]["scale"]),
        "ln2b": f32(blocks["ln_2"]["bias"]),
        "qkvw": mat(blocks["attn"]["c_attn"]["w"]),
        "attnb": f32(blocks["attn"]["c_attn"]["b"]),
        "projw": mat(blocks["attn"]["c_proj"]["w"]),
        "projb": f32(blocks["attn"]["c_proj"]["b"]),
        "fcw": mat(blocks["mlp"]["c_fc"]["w"]),
        "fcb": f32(blocks["mlp"]["c_fc"]["b"]),
        "cprojw": mat(blocks["mlp"]["c_proj"]["w"]),
        "cprojb": f32(blocks["mlp"]["c_proj"]["b"]),
        "lnf": f32(torch.stack([params["ln_f"]["scale"], params["ln_f"]["bias"]])),
        "wte": params["wte"].to(compute_dtype).contiguous(),
    }


# ---------------------------------------------------------------------------
# Fused linear: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

def _gelu_new(x32: torch.Tensor) -> torch.Tensor:
    # the step kernel's form (x*x*x, not x**3), decode_step.py:76-78
    c = 0.7978845608028654
    return 0.5 * x32 * (1.0 + torch.tanh(c * (x32 + 0.044715 * x32 * x32 * x32)))


def fused_linear_plain(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None):
    """Plain twin of ``csrc/fused_linear.cu``; same arguments as
    :func:`fused_linear_cuda`."""
    cdt = w.dtype
    if ln is not None:
        x = nn.layer_norm({"scale": ln[0], "bias": ln[1]}, x.float(), eps).to(cdt)
    y = nn.dot_f32(x.to(cdt), w.t()) + bias.float()
    if epilogue == "cast":
        return y.to(cdt)
    if epilogue == "gelu":
        return _gelu_new(y).to(cdt)
    residual += y
    return residual


def fused_linear_cuda(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None):
    """Launch ``csrc/fused_linear.cu``: ``epilogue(prologue(x) @ w.T + bias)``.

    x: (M, K) — the float32 residual stream when ``ln=(scale, bias)`` (the
    LayerNorm prologue), else the compute dtype; w: (N, K) compute dtype;
    bias: (N,) float32.  ``epilogue`` "cast" or "gelu" returns a new (M, N)
    tensor in the compute dtype; "residual" adds into ``residual`` (M, N)
    float32 in place and returns it.
    """
    name = "fused_linear"
    cdt = w.dtype
    _build.require(x.is_cuda, name, "x must be a CUDA tensor")
    _build.require(cdt in _build.DTYPE_CODE, name, f"unsupported weight dtype {cdt}")
    _build.require(epilogue in EPILOGUES, name, f"unknown epilogue {epilogue!r}")
    m, k = x.shape
    n = w.shape[0]
    _build.require(w.shape == (n, k) and w.is_contiguous(), name, "w must be contiguous (N, K)")
    _build.require(x.is_contiguous(), name, "x must be contiguous")
    _build.require(k % (16 // w.element_size()) == 0 and x.data_ptr() % 16 == 0
                   and w.data_ptr() % 16 == 0, name,
                   "K must be a multiple of 8 (bf16) or 4 (float32), x and w 16-byte aligned")
    _build.require(x.dtype == (torch.float32 if ln is not None else cdt), name,
                   "x must be float32 with the LN prologue, else the weight dtype")
    _build.require(bias.shape == (n,) and bias.dtype == torch.float32 and bias.is_contiguous(),
                   name, "bias must be contiguous float32 (N,)")
    ln_s = ln_b = stats = 0
    if ln is not None:
        for t in ln:
            _build.require(t.shape == (k,) and t.dtype == torch.float32 and t.is_contiguous(),
                           name, "LN scale/bias must be contiguous float32 (K,)")
        ln_s, ln_b = ln[0].data_ptr(), ln[1].data_ptr()
        stats_buf = torch.empty((m, 2), dtype=torch.float32, device=x.device)  # (mean, rstd)
        stats = stats_buf.data_ptr()
    if epilogue == "residual":
        _build.require(residual is not None and residual.shape == (m, n)
                       and residual.dtype == torch.float32 and residual.is_contiguous(), name,
                       "the residual epilogue needs a contiguous float32 (M, N) stream")
        _build.require(residual.data_ptr() != x.data_ptr(), name,
                       "the residual stream cannot also be the input")
        out = residual
    else:
        out = torch.empty((m, n), dtype=cdt, device=x.device)
    for t in (w, bias, out):
        _build.require(t.device == x.device, name, "all tensors must be on one device")
    err = _build.library().gic_fused_linear(
        _build.DTYPE_CODE[cdt], int(ln is not None), EPILOGUES[epilogue], x.data_ptr(), ln_s, ln_b,
        eps, w.data_ptr(), bias.data_ptr(), out.data_ptr(), stats, m, k, n, _build.stream_of(x),
    )
    _build.check(err, name)
    fused_linear_cuda.launches += 1
    return out


fused_linear_cuda.launches = 0


def fused_linear(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None,
                 use_kernel: bool | None = None):
    fn = fused_linear_cuda if _build.kernels_enabled(use_kernel, x.device) else fused_linear_plain
    return fn(x, w, bias, epilogue=epilogue, ln=ln, eps=eps, residual=residual)


# ---------------------------------------------------------------------------
# Final LN + logits + greedy argmax: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

def logits_plain(x32, lnf, wte, eps: float = 1e-5) -> torch.Tensor:
    """(B, V) float32 logits of the step: LN_f in float32, cast to the compute
    dtype, times wte^T with float32 accumulation."""
    xf = nn.layer_norm({"scale": lnf[0], "bias": lnf[1]}, x32.float(), eps).to(wte.dtype)
    return nn.dot_f32(xf, wte.t())


def logits_argmax_plain(x32, lnf, wte, eps: float = 1e-5) -> torch.Tensor:
    """Plain twin of ``csrc/logits_argmax.cu``: (B,) int32 greedy tokens
    (``torch.argmax`` returns the first index of the max)."""
    return torch.argmax(logits_plain(x32, lnf, wte, eps), dim=-1).to(torch.int32)


def logits_argmax_cuda(x32, lnf, wte, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/logits_argmax.cu``.  x32: (B, D) float32 residual stream;
    lnf: (2, D) float32 LN_f scale and bias; wte: (V, D) compute dtype.
    Returns (B,) int32."""
    name = "logits_argmax"
    _check_vocab_args(name, x32, lnf, wte)
    b, d = x32.shape
    v = wte.shape[0]
    nblk = -(-v // 32)  # csrc/common.cuh BN
    xf = torch.empty((b, d), dtype=wte.dtype, device=x32.device)
    part_val = torch.empty((b, nblk), dtype=torch.float32, device=x32.device)
    part_idx = torch.empty((b, nblk), dtype=torch.int32, device=x32.device)
    tok = torch.empty((b,), dtype=torch.int32, device=x32.device)
    err = _build.library().gic_logits_argmax(
        _build.DTYPE_CODE[wte.dtype], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), b, d, v, xf.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        tok.data_ptr(), _build.stream_of(x32),
    )
    _build.check(err, name)
    logits_argmax_cuda.launches += 1
    return tok


logits_argmax_cuda.launches = 0


def logits_argmax(x32, lnf, wte, eps: float = 1e-5, *, use_kernel: bool | None = None):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_argmax_cuda(x32, lnf, wte, eps)
    return logits_argmax_plain(x32, lnf, wte, eps)


def _check_vocab_args(name, x32, lnf, wte) -> None:
    """The argument checks the three vocabulary kernels share."""
    _build.require(x32.is_cuda, name, "x32 must be a CUDA tensor")
    _build.require(wte.dtype in _build.DTYPE_CODE, name, f"unsupported wte dtype {wte.dtype}")
    d = x32.shape[1]
    _build.require(x32.dtype == torch.float32 and x32.is_contiguous(), name,
                   "x32 must be contiguous float32")
    _build.require(wte.shape[1] == d and wte.is_contiguous(), name,
                   "wte must be contiguous (V, D)")
    _build.require(d % (16 // wte.element_size()) == 0 and x32.data_ptr() % 16 == 0
                   and wte.data_ptr() % 16 == 0, name,
                   "D must be a multiple of 8 (bf16) or 4 (float32), x32 and wte 16-byte aligned")
    _build.require(lnf.shape == (2, d) and lnf.dtype == torch.float32 and lnf.is_contiguous(), name,
                   "lnf must be contiguous float32 (2, D)")
    for t in (lnf, wte):
        _build.require(t.device == x32.device, name, "all tensors must be on one device")


# ---------------------------------------------------------------------------
# Final LN + logits stored (emit_logits): kernel, dispatcher (twin: logits_plain)
# ---------------------------------------------------------------------------

def logits_cuda(x32, lnf, wte, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/logits.cu``: the (B, V) float32 logits of
    :func:`logits_plain`.  Arguments as :func:`logits_argmax_cuda`."""
    name = "logits"
    _check_vocab_args(name, x32, lnf, wte)
    b, d = x32.shape
    v = wte.shape[0]
    xf = torch.empty((b, d), dtype=wte.dtype, device=x32.device)
    out = torch.empty((b, v), dtype=torch.float32, device=x32.device)
    err = _build.library().gic_logits(
        _build.DTYPE_CODE[wte.dtype], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), b, d, v, xf.data_ptr(), out.data_ptr(), _build.stream_of(x32),
    )
    _build.check(err, name)
    logits_cuda.launches += 1
    return out


logits_cuda.launches = 0


def logits(x32, lnf, wte, eps: float = 1e-5, *, use_kernel: bool | None = None):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_cuda(x32, lnf, wte, eps)
    return logits_plain(x32, lnf, wte, eps)


# ---------------------------------------------------------------------------
# Final LN + logits → per-row top-k and logsumexp: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

TOPK_MAX = 16  # csrc/logits_topk.cu kMaxK


def logits_topk_plain(x32, lnf, wte, k: int, eps: float = 1e-5):
    """Plain twin of ``csrc/logits_topk.cu``: :func:`logits_plain`, then
    :func:`ops.sampling.topk_small` and the logsumexp.  Returns (values (B, k)
    float32, ids (B, k) int32, lse (B, 1) float32)."""
    lg = logits_plain(x32, lnf, wte, eps)
    vals, ids = topk_small(lg, k)
    return vals, ids, torch.logsumexp(lg, dim=-1, keepdim=True)


def logits_topk_cuda(x32, lnf, wte, k: int, eps: float = 1e-5):
    """Launch ``csrc/logits_topk.cu``: :func:`logits_topk_plain`'s outputs,
    the (B, V) logits never stored.  Arguments as :func:`logits_argmax_cuda`;
    1 <= k <= min(16, V)."""
    name = "logits_topk"
    _check_vocab_args(name, x32, lnf, wte)
    b, d = x32.shape
    v = wte.shape[0]
    _build.require(1 <= k <= min(TOPK_MAX, v), name, f"k must be in [1, {min(TOPK_MAX, v)}]")
    nblk = -(-v // 32)  # csrc/common.cuh BN
    dev = x32.device
    xf = torch.empty((b, d), dtype=wte.dtype, device=dev)
    part_val = torch.empty((b, nblk, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, nblk, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    part_s = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    lse = torch.empty((b, 1), dtype=torch.float32, device=dev)
    err = _build.library().gic_logits_topk(
        _build.DTYPE_CODE[wte.dtype], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), b, d, v, k, xf.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
        part_m.data_ptr(), part_s.data_ptr(), vals.data_ptr(), ids.data_ptr(), lse.data_ptr(),
        _build.stream_of(x32),
    )
    _build.check(err, name)
    logits_topk_cuda.launches += 1
    return vals, ids, lse


logits_topk_cuda.launches = 0


def logits_topk(x32, lnf, wte, k: int, eps: float = 1e-5, *, use_kernel: bool | None = None):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_topk_cuda(x32, lnf, wte, k, eps)
    return logits_topk_plain(x32, lnf, wte, k, eps)


# ---------------------------------------------------------------------------
# Final LN + logits → per-row temperature / top-p draw (sample): kernel,
# dispatcher (twin: ops.sampling.sample_step_plain)
# ---------------------------------------------------------------------------

SAMPLE_K_MAX = 4  # csrc/logits_sample.cu kMaxCand
_SAMPLE_TILES = 8  # csrc/logits_sample.cu kTilesPerBlock


def logits_sample_cuda(x32, lnf, wte, temp, top_p, seed: int, k: int = 3, rounds: int = 6,
                       eps: float = 1e-5):
    """Launch ``csrc/logits_sample.cu``: :func:`ops.sampling.sample_step_plain`'s
    outputs, (token (B,) int32, round (B,) int32, lse (B, 1) float32), the
    (B, V) logits never stored.  Arguments as :func:`logits_argmax_cuda`;
    temp, top_p (B,) float32 on the same device; ``seed`` a 64-bit int keying
    the kernel's Philox; 1 <= k <= 4; rounds >= 0.  2 + rounds CUDA launches,
    none of which the host waits for."""
    name = "logits_sample"
    _check_vocab_args(name, x32, lnf, wte)
    b, d = x32.shape
    v = wte.shape[0]
    _build.require(1 <= k <= SAMPLE_K_MAX, name, f"k must be in [1, {SAMPLE_K_MAX}]")
    _build.require(rounds >= 0, name, "rounds must be >= 0")
    for t in (temp, top_p):
        _build.require(t.shape == (b,) and t.dtype == torch.float32 and t.is_contiguous()
                       and t.device == x32.device, name,
                       "temp and top_p must be contiguous float32 (B,) on x32's device")
    ntiles = -(-v // 32)  # common.cuh BN
    ncb = -(-ntiles // _SAMPLE_TILES)
    dev = x32.device
    xf = torch.empty((b, d), dtype=wte.dtype, device=dev)
    part_f = torch.empty((b * ncb * (3 + 3 * k),), dtype=torch.float32, device=dev)
    part_i = torch.empty((b * ncb * (1 + k),), dtype=torch.int32, device=dev)
    state_i = torch.empty((b * (1 + k),), dtype=torch.int32, device=dev)
    state_f = torch.empty((b * k,), dtype=torch.float32, device=dev)
    counters = torch.zeros((1 + -(-b // 64),), dtype=torch.int32, device=dev)  # common.cuh BM
    tok = torch.empty((b,), dtype=torch.int32, device=dev)
    rnd = torch.empty((b,), dtype=torch.int32, device=dev)
    lse = torch.empty((b, 1), dtype=torch.float32, device=dev)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    err = _build.library().gic_logits_sample(
        _build.DTYPE_CODE[wte.dtype], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), b, d, v, temp.data_ptr(), top_p.data_ptr(), seed & 0xFFFFFFFF,
        seed >> 32, k, rounds, xf.data_ptr(), part_f.data_ptr(), part_i.data_ptr(),
        state_i.data_ptr(), state_f.data_ptr(), counters.data_ptr(), tok.data_ptr(),
        rnd.data_ptr(), lse.data_ptr(), _build.stream_of(x32),
    )
    _build.check(err, name)
    logits_sample_cuda.launches += 1
    return tok, rnd, lse


logits_sample_cuda.launches = 0


def logits_sample(x32, lnf, wte, temp, top_p, seed: int, k: int = 3, rounds: int = 6,
                  eps: float = 1e-5, *, use_kernel: bool | None = None):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_sample_cuda(x32, lnf, wte, temp, top_p, seed, k, rounds, eps)
    return sample_step_plain(x32, lnf, wte, temp, top_p, seed, k, rounds, eps=eps)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def decode_layers(packed, x0, k_cache, v_cache, idx: int, *, n_head: int, eps: float = 1e-5,
                  origin=None, gather_start: int = 0, start=None,
                  use_kernels: bool | None = None) -> torch.Tensor:
    """All layers of one step: returns the (B, D) float32 residual stream
    before the final LN.  Appends each layer's K/V at ``idx`` in place;
    ``origin``/``gather_start``/``start`` as in
    :func:`ops.decode_attention.decode_attention`."""
    d = x0.shape[1]
    x32 = x0.to(torch.float32, copy=True)
    for l in range(k_cache.shape[0]):
        qkv = fused_linear(
            x32, packed["qkvw"][l], packed["attnb"][l], epilogue="cast",
            ln=(packed["ln1s"][l], packed["ln1b"][l]), eps=eps, use_kernel=use_kernels,
        )
        a, _, _ = decode_attention(
            qkv[:, :d], qkv[:, d : 2 * d], qkv[:, 2 * d :], k_cache[l], v_cache[l], idx,
            n_head=n_head, origin=origin, gather_start=gather_start, start=start,
            use_kernel=use_kernels,
        )
        fused_linear(a, packed["projw"][l], packed["projb"][l], epilogue="residual",
                     residual=x32, use_kernel=use_kernels)
        h = fused_linear(
            x32, packed["fcw"][l], packed["fcb"][l], epilogue="gelu",
            ln=(packed["ln2s"][l], packed["ln2b"][l]), eps=eps, use_kernel=use_kernels,
        )
        fused_linear(h, packed["cprojw"][l], packed["cprojb"][l], epilogue="residual",
                     residual=x32, use_kernel=use_kernels)
    return x32


def fused_decode_step(
    packed: dict,
    x0: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    idx: int,
    *,
    n_head: int,
    eps: float = 1e-5,
    emit_logits: bool = False,
    topk: int = 0,
    origin: torch.Tensor | None = None,
    beam_k: int = 0,
    gather_start: int = 0,
    start: torch.Tensor | None = None,
    sample: dict | None = None,
    sample_k: int = 3,
    sample_rounds: int = 6,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, ...]:
    """One decode step.

    x0: (B, D) input embeddings (token + position) in the compute dtype;
    caches (L, Tpad, B, D) with rows ``[0, idx)`` valid, updated in place at
    row ``idx``.  Returns, by mode:

    - greedy (default): ``(next_token (B,) int32, k_cache, v_cache)``;
    - ``emit_logits=True``: ``(logits (B, V) float32, k_cache, v_cache)``;
    - ``topk=k``: ``(values (B, k) float32, token_ids (B, k) int32,
      logsumexp (B, 1) float32, k_cache, v_cache)``, values descending, ties
      to the smallest id;
    - ``sample={"temp": (B,) f32, "top_p": (B,) f32, "seed": int}``:
      ``(token (B,) int32, resolve_round (B,) int32, logsumexp (B, 1)
      float32, k_cache, v_cache)`` — the in-kernel draw by speculative accept
      with ``sample_k`` candidates and ``sample_rounds`` rounds
      (:func:`ops.sampling.sample_step_plain`); rows with temp 0 take the
      argmax and report round 0.

    Beam mode (``origin`` and ``beam_k``, with any vocabulary mode but
    ``sample``): row r's attention reads position t in ``[gather_start,
    idx)`` from cache row ``origin[t, r]`` of the (Tpad, B) int32 map; rows
    are beam-major, B a multiple of ``beam_k``.  ``start`` ((B,) int32, any
    vocabulary mode, not with beam mode): row r attends only its window
    ``[start_r, idx)`` and its new row — continuous batching.
    ``use_kernels=False`` is the step's plain twin.  The int8 cache
    (``k_scale``/``v_scale``) is not ported and raises.
    """
    if sample is not None and (topk or emit_logits or beam_k):
        raise ValueError("sample mode is exclusive with topk/emit_logits/beam")
    if start is not None and origin is not None:
        raise ValueError("start and origin are exclusive (beam search never passes a start)")
    if k_scale is not None or v_scale is not None or k_cache.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, queue 2, item 2, mode 7: int8 KV)"
        )
    if (origin is None) != (beam_k == 0):
        raise ValueError("beam mode needs origin and beam_k together")
    if topk and emit_logits:
        raise ValueError("topk and emit_logits are exclusive")
    if beam_k and x0.shape[0] % beam_k:
        raise ValueError(f"batch {x0.shape[0]} is not a whole number of beam groups of {beam_k}")
    use = fused_greedy_enabled(use_kernels, x0.device)
    x32 = decode_layers(packed, x0, k_cache, v_cache, int(idx), n_head=n_head, eps=eps,
                        origin=origin, gather_start=gather_start, start=start, use_kernels=use)
    lnf, wte = packed["lnf"], packed["wte"]
    if sample is not None:
        b = x0.shape[0]
        temp = torch.as_tensor(sample["temp"], dtype=torch.float32, device=x0.device).reshape(b)
        top_p = torch.as_tensor(sample["top_p"], dtype=torch.float32, device=x0.device).reshape(b)
        tok, rnd, lse = logits_sample(x32, lnf, wte, temp.contiguous(), top_p.contiguous(),
                                      int(sample["seed"]), sample_k, sample_rounds, eps,
                                      use_kernel=use)
        return tok, rnd, lse, k_cache, v_cache
    if topk:
        return (*logits_topk(x32, lnf, wte, topk, eps, use_kernel=use), k_cache, v_cache)
    if emit_logits:
        return logits(x32, lnf, wte, eps, use_kernel=use), k_cache, v_cache
    return logits_argmax(x32, lnf, wte, eps, use_kernel=use), k_cache, v_cache
