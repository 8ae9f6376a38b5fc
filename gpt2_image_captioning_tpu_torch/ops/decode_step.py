"""The GPT-2 decode step — the counterpart of
``gpt2_image_captioning_tpu/ops/decode_step.py`` in its greedy,
``emit_logits``, ``topk``, beam-ancestry, per-row ``start`` and in-kernel
``sample`` modes, each with float or int8 (W8A8) weights, and its int8 KV
cache.

On the TPU the whole step is one Pallas kernel (``_step_kernel``), because
each kernel call there carries a large fixed cost.  Blocks on Hopper cannot
synchronise across layers without a grid-wide barrier, so the port runs the
step as a short sequence of hand-written kernels, five calls per layer and one
for the vocabulary:

- ``csrc/fused_linear.cu`` — ``y = epilogue(prologue(x) @ W + b)``: the QKV
  projection (LN1 prologue), the attention output projection (residual-add
  epilogue), the MLP up-projection (LN2 prologue, gelu_new epilogue) and its
  down-projection (residual add); in bf16, int8 and float32 (``wgmma`` TF32,
  the three-term split) a TMA ring, ``wgmma`` and a K split over a
  thread-block cluster, planned per shape by :func:`linear_plan`;
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
accumulation of the products, float32 LayerNorm statistics, a float32
residual stream to which the projections are added unrounded, and ties to
the smallest token id.  Every kernel has a plain PyTorch twin in this module
(or in ``ops/decode_attention.py``) with the same arithmetic; the CPU runs
the twins, and ``use_kernels=False`` runs them on the card for comparison.
The LayerNorm statistics, gelu_new and the attention (scores, softmax, p·v)
run in float64 in kernel and twin alike and are rounded once
(:func:`ops.nn.layer_norm_rows`, :func:`_gelu_new`), so their results do
not depend on the order of the sums: with int8 weights, whose integer
products are exact, the kernels and the twins then compute the same step,
where a one-ulp difference would now and then cross a quantization step
and grow through the later layers.

W8A8 (``pack_decode_weights(quant=True)``; the pack carries ``qkvs``): the
four projections and wte are int8 with per-output-column float32 scales;
each call quantizes its input rows — after the LayerNorm and the cast in
a launch of ``csrc/rowquant.cu`` where the role has one (LN1 -> qkv, LN2 ->
fc, LN_f -> the vocabulary), inside the product's own launch where it has
none (the attention output -> proj, gelu(h) -> cproj) — and multiplies int8
by int8 with int32 accumulators, dequantized as ``acc * sx * sw`` before
the same epilogues.  int8 KV cache (int8 caches with ``k_scale``/``v_scale``): each
new K/V row is quantized over its D and appended with its scale, and the
walk dequantizes in the compute dtype; the new row's own term is exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.decode_attention import decode_attention
from gpt2_image_captioning_tpu_torch.ops.quant import (  # noqa: F401 (re-exported)
    colquant, int8_matmul, quantize_cache, rowquant_cuda, rowquant_plain,
)
from gpt2_image_captioning_tpu_torch.ops.sampling import sample_step_plain, topk_small

# epilogue codes of csrc/fused_linear.cu
EPILOGUES = {"cast": 0, "gelu": 1, "residual": 2}

# csrc/fused_linear.cu's route (its LIN_* constants)
LINEAR_BN = (32, 64, 128)        # the wgmma widths: output columns a block
LINEAR_SPLITS = (1, 2, 3, 4, 6, 8)  # K-slices of a column tile (<= 8: a portable cluster)
LINEAR_BOX_BYTES = 128           # K bytes of a TMA box and a ring stage
LINEAR_RING_BUDGET = 110 * 1024  # a block's ring, so that two blocks share an SM
LINEAR_RING_BUDGET_ONE = 220 * 1024  # a block an SM: float32, or rows quantized in the product
                                     # with blocks <= SMs
LINEAR_MAX_STAGES = 8
LINEAR_PAD = 8                   # the partial tile's row pitch is bn + LINEAR_PAD
SMS = 132                        # the H100's streaming multiprocessors
# what a K-slice costs a block beyond its bytes (the cluster barriers and the
# partials' round trip), in bytes streamed: fitted to scripts/linear_plan_sweep.py
LINEAR_SPLIT_BYTES = 8 * 1024
# float32: what a wave of blocks costs beside its products (the TMA round
# trip, the converters' first box, the cluster barriers, the epilogue), in a
# block's products (rows x columns x K), and the clusters a wave holds: a
# cluster stays inside a GPC, and the H100's 8 GPCs hold >= 16 SMs each.
# Fitted to scripts/linear_plan_sweep.py's float32 times on an H100 (any
# value in 2-3 M picks the fastest split in all 16 of its cases).
LINEAR_WAVE_PRODUCTS = 2_500_000
LINEAR_GPCS, LINEAR_GPC_SMS = 8, 16
# float32: the most boxes a K-slice takes (800 floats: 300 TF32 product
# instructions into one accumulator, GPT-2 XL's K 6,400 in 8 slices).  The
# tensor core's float32 accumulation drifts by up to half an ulp of the
# running sum an instruction: on an H100 a slice of 1,200 instructions (K
# 6,400 in two) parted from the float32 twin by 1.8e-4, past the checks'
# 1e-4 + 1e-4 |y|; 144 instructions by 1.7e-5.
LINEAR_TF32_BOXES = 25


class LinearPlan(NamedTuple):
    bn: int         # output columns a block
    splits: int     # K-slices of a column tile: the blocks of its cluster
    k_slice: int    # K elements a slice (whole boxes); the last slice ends at K
    n_tiles: int    # column tiles
    row_tiles: int  # row tiles of 64 x consumers rows
    consumers: int  # consumer warpgroups, 64 rows each
    stages: int     # the ring's depth (fused_linear.cu::lin_stages)
    smem: int       # dynamic shared memory bytes of a block (fused_linear.cu::lin_smem)

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.splits * self.row_tiles


def linear_plan_options(m: int, k: int, n: int, element_size: int,
                        row_bytes: int | None = None) -> list[LinearPlan]:
    """Every split ``csrc/fused_linear.cu`` can run an (M, K) x (K, N)
    product with ``element_size``-byte operands (2 bf16, 1 int8, 4 float32)
    in: a block owns ``bn`` output columns, every row up to 128 (more rows
    take more row tiles) and one K-slice of whole 128-byte boxes; the
    ``splits`` slices of a column tile, none empty, form a cluster that
    reduces their partial tiles in rank order (clusters of 5 and 7 left
    out: they measured slower than their neighbours on the card).
    ``row_bytes``: the bytes of a row element as the ring carries it,
    ``element_size`` (the default), or with int8 weights 2 or 4 where the
    product quantizes its bf16 or float32 rows itself (a stage then holds 2
    or 4 row boxes; a grid of no more blocks than SMs then takes one block
    an SM and a ring twice the size).  float32 holds each box twice, its
    TF32 hi and lo (the row pair and W's second slot), and a block takes an
    SM (its converter warps' registers) and the larger ring.  ``stages`` and
    ``smem`` mirror the kernel's own sizing of its ring (``lin_stage_bytes``,
    ``lin_budget``, ``lin_stages``, ``lin_smem``)."""
    consumers = 1 if m <= 64 else 2
    bm = 64 * consumers
    row_tiles = -(-m // bm)
    boxes = -(-k // (LINEAR_BOX_BYTES // element_size))
    abox = (row_bytes or element_size) // element_size
    tf32 = element_size == 4
    plans = []
    for bn in LINEAR_BN:
        stage = (bm * abox + bn) * (2 if tf32 else 1) * LINEAR_BOX_BYTES
        for splits in LINEAR_SPLITS:
            per = -(-boxes // splits)
            if -(-boxes // per) != splits:  # a slice would be empty
                continue
            one = tf32 or (abox > 1 and -(-n // bn) * splits * row_tiles <= SMS)
            budget = LINEAR_RING_BUDGET_ONE if one else LINEAR_RING_BUDGET
            stages = max(1, min(per, budget // stage, LINEAR_MAX_STAGES))
            smem = 1024 + max(stages * stage, bm * (bn + LINEAR_PAD) * 4)
            plans.append(LinearPlan(bn, splits, per * LINEAR_BOX_BYTES // element_size,
                                    -(-n // bn), row_tiles, consumers, stages, smem))
    return plans


@functools.lru_cache(maxsize=None)
def linear_plan(m: int, k: int, n: int, element_size: int,
                row_bytes: int | None = None) -> LinearPlan:
    """The split :func:`fused_linear_cuda` launches an (M, K) x (K, N)
    product in, once per shape: among :func:`linear_plan_options` that give
    at least one block an SM (or the most blocks the shape allows), the one
    whose blocks stream the fewest bytes — a block's row and weight boxes,
    the partial tiles it reads and ``LINEAR_SPLIT_BYTES`` a K-slice, times
    the waves of two blocks an SM — ties to wider tiles.  On an H100 this
    rule picks, at 128 and 512 rows of every GPT-2 124M role, bf16 and
    int8, a split within 1.3 us of the fastest one that
    ``scripts/linear_plan_sweep.py`` timed; at 1,920 and 120 rows (the
    prefill's products, bf16) within 1.3 us of it.  ``row_bytes`` as in
    :func:`linear_plan_options`.  Where the product quantizes its own rows,
    converting them sets its time: the fewest values a block converts
    (64 x consumers rows by its K-slice) times the blocks an SM, ties to
    more blocks — on the card the fastest split at 128 and 512 rows of
    attn_proj and mlp_proj, or within 0.3 us of it.  float32 (a block an
    SM, three TF32 products a k8 step) is set by its products: the fewest a
    block runs (64 x consumers rows x ``bn`` x its K-slice), plus what a
    wave costs beside them (``LINEAR_WAVE_PRODUCTS``), times its waves of
    one block an SM in clusters that the GPCs hold (a cluster of 6 leaves
    4 SMs of a 16-SM GPC idle); then the bytes as above — on an H100 the
    fastest split at 128, 512, 1,920 and 120 rows of every role — among
    the splits whose K-slices keep within ``LINEAR_TF32_BOXES``."""
    options = linear_plan_options(m, k, n, element_size, row_bytes)
    abox = (row_bytes or element_size) // element_size
    if abox > 1:
        return min(options, key=lambda p: (-(-p.blocks // SMS) * 64 * p.consumers * p.k_slice,
                                           -p.blocks))
    tf32 = element_size == 4

    def cost(p: LinearPlan):
        bm = 64 * p.consumers
        boxes = p.k_slice * element_size // LINEAR_BOX_BYTES
        streamed = boxes * (bm * abox + p.bn) * LINEAR_BOX_BYTES
        reduced = bm * p.bn * 4 if p.splits > 1 else 0
        if tf32:  # a block an SM, in as many clusters as the GPCs hold
            held = SMS if p.splits == 1 else LINEAR_GPCS * (LINEAR_GPC_SMS // p.splits) * p.splits
            waves = -(-p.blocks // held)
            work = waves * (bm * p.bn * p.k_slice + LINEAR_WAVE_PRODUCTS)
        else:
            waves, work = -(-p.blocks // (2 * SMS)), 0
        return work, waves * (streamed + reduced + LINEAR_SPLIT_BYTES * p.splits), -p.bn

    if tf32:  # the shortest accumulator chains where no option keeps within LINEAR_TF32_BOXES
        boxes = -(-k // (LINEAR_BOX_BYTES // element_size))
        cap = max(LINEAR_TF32_BOXES, -(-boxes // LINEAR_SPLITS[-1]))
        return min((p for p in options if p.k_slice * element_size // LINEAR_BOX_BYTES <= cap),
                   key=cost)
    wave = min(SMS, max(p.blocks for p in options))
    return min((p for p in options if p.blocks >= wave), key=cost)


def fused_greedy_enabled(use_kernels: bool | None, device) -> bool:
    """Whether decoding on ``device`` runs the CUDA kernels (True) or their
    plain twins (False), in every mode of the step.  Unlike the JAX package
    there is no width, dtype or beam-block gate: on CUDA the kernels run in
    bf16 and float32 at any width, batch and beam size."""
    return _build.kernels_enabled(use_kernels, device)


def pack_decode_weights(params: dict, compute_dtype: torch.dtype = torch.bfloat16,
                        quant: bool = False) -> dict:
    """One-time re-layout of the stacked GPT-2 params for the step kernels.

    The kernels read every weight output-major, (N, K) with each output
    column's K weights contiguous — the layout the tied embedding already has.
    So the (L, in, out) ``Conv1D`` matrices are transposed once to
    (L, out, in) in the compute dtype; wte stays (V, D).  LayerNorm params and
    biases are float32.

    ``quant=True`` packs the W8A8 mode: the four matrices and wte are
    quantized per output column from their float32 values
    (:func:`ops.quant.colquant`) and stored int8 in the same layouts, with
    float32 scales ``qkvs``/``projs``/``fcs``/``cprojs`` (L, N) and ``wtes``
    (V,) — a per-output-column scale is a per-row scale of the stored
    matrix.  The step's int8 mode is keyed on ``"qkvs" in packed``.
    """
    blocks = params["blocks"]

    def mat(w):
        return w.to(compute_dtype).transpose(1, 2).contiguous()

    def f32(t):
        return t.to(torch.float32).contiguous()

    mats = {"qkvw": blocks["attn"]["c_attn"]["w"], "projw": blocks["attn"]["c_proj"]["w"],
            "fcw": blocks["mlp"]["c_fc"]["w"], "cprojw": blocks["mlp"]["c_proj"]["w"]}
    if quant:
        out = {}
        for name, w in mats.items():
            wq, sw = colquant(w.float())
            out[name] = wq.transpose(1, 2).contiguous()
            out[name[:-1] + "s"] = sw.contiguous()  # qkvs / projs / fcs / cprojs
        wq, sw = colquant(params["wte"].float().t())  # (D, V): a column per token
        out["wte"], out["wtes"] = wq.t().contiguous(), sw.contiguous()
    else:
        out = {name: mat(w) for name, w in mats.items()}
        out["wte"] = params["wte"].to(compute_dtype).contiguous()
    return {
        **out,
        "ln1s": f32(blocks["ln_1"]["scale"]),
        "ln1b": f32(blocks["ln_1"]["bias"]),
        "ln2s": f32(blocks["ln_2"]["scale"]),
        "ln2b": f32(blocks["ln_2"]["bias"]),
        "attnb": f32(blocks["attn"]["c_attn"]["b"]),
        "projb": f32(blocks["attn"]["c_proj"]["b"]),
        "fcb": f32(blocks["mlp"]["c_fc"]["b"]),
        "cprojb": f32(blocks["mlp"]["c_proj"]["b"]),
        "lnf": f32(torch.stack([params["ln_f"]["scale"], params["ln_f"]["bias"]])),
    }


# ---------------------------------------------------------------------------
# Fused linear: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

def _gelu_new(x32: torch.Tensor) -> torch.Tensor:
    # the step kernel's form (x*x*x, not x**3), decode_step.py:76-78, in
    # float64 and rounded once to float32, as csrc/common.cuh::gelu_new
    c = 0.7978845608028654
    x = x32.double()
    return (0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))).float()


def fused_linear_plain(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None,
                       w_scale=None, compute_dtype=None):
    """Plain twin of ``csrc/fused_linear.cu``; same arguments as
    :func:`fused_linear_cuda`."""
    cdt = compute_dtype or w.dtype
    if w_scale is not None:
        xq, sx = rowquant_plain(x, ln, eps, cdt)
        y = int8_matmul(xq, sx, w, w_scale) + bias.float()
    else:
        if ln is not None:
            x = nn.layer_norm_rows(ln[0], ln[1], x.float(), eps).to(cdt)
        y = nn.dot_f32(x.to(cdt), w.t()) + bias.float()
    if epilogue == "cast":
        return y.to(cdt)
    if epilogue == "gelu":
        return _gelu_new(y).to(cdt)
    residual += y
    return residual


def fused_linear_cuda(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None,
                      w_scale=None, compute_dtype=None):
    """Launch ``csrc/fused_linear.cu``: ``epilogue(prologue(x) @ w.T + bias)``.

    x: (M, K) — the float32 residual stream when ``ln=(scale, bias)`` (the
    LayerNorm prologue), else the compute dtype; w: (N, K) in the compute
    dtype, or int8 with ``w_scale`` (N,) float32 (W8A8: the call quantizes x
    per row, then multiplies in int8; with ``ln`` in one more CUDA launch,
    ``csrc/rowquant.cu``, as the bf16 LayerNorm roles' pre-pass is, without
    it inside the product's own launch); bias: (N,) float32.
    ``compute_dtype`` defaults to w's, and int8 weights need it.  float32
    weights run the TF32 route (the three-term split on ``wgmma``); with
    ``ln`` the pre-pass writes the rows' TF32 pair into a (2M, K) scratch.
    ``epilogue`` "cast" or "gelu" returns a new (M, N) tensor in the compute
    dtype; "residual" adds into ``residual`` (M, N) float32 in place and
    returns it.
    """
    name = "fused_linear"
    quant = w_scale is not None
    cdt = compute_dtype or w.dtype
    _build.require(x.is_cuda, name, "x must be a CUDA tensor")
    _build.require(cdt in _build.DTYPE_CODE, name, f"unsupported compute dtype {cdt}")
    _build.require(w.dtype == (torch.int8 if quant else cdt), name,
                   "w must be int8 with w_scale, else the compute dtype")
    _build.require(epilogue in EPILOGUES, name, f"unknown epilogue {epilogue!r}")
    m, k = x.shape
    n = w.shape[0]
    _build.require(w.shape == (n, k) and w.is_contiguous(), name, "w must be contiguous (N, K)")
    _build.require(x.is_contiguous(), name, "x must be contiguous")
    _build.require(k % (16 // w.element_size()) == 0 and x.data_ptr() % 16 == 0
                   and w.data_ptr() % 16 == 0, name,
                   "K must be a multiple of 16 (int8), 8 (bf16) or 4 (float32), x and w 16-byte "
                   "aligned")
    _build.require(x.dtype == (torch.float32 if ln is not None else cdt), name,
                   "x must be float32 with the LN prologue, else the compute dtype")
    _build.require(bias.shape == (n,) and bias.dtype == torch.float32 and bias.is_contiguous(),
                   name, "bias must be contiguous float32 (N,)")
    ln_s = ln_b = xa = sx = w_s = None
    if ln is not None:
        for t in ln:
            _build.require(t.shape == (k,) and t.dtype == torch.float32 and t.is_contiguous(),
                           name, "LN scale/bias must be contiguous float32 (K,)")
        ln_s, ln_b = ln[0].data_ptr(), ln[1].data_ptr()
    if quant:
        _build.require(w_scale.shape == (n,) and w_scale.dtype == torch.float32
                       and w_scale.is_contiguous() and w_scale.device == x.device, name,
                       "w_scale must be contiguous float32 (N,) on x's device")
        w_s = w_scale.data_ptr()
        if ln is not None:  # the quantizer's rows and scales, the product's operand
            xa_buf = torch.empty((m, k), dtype=torch.int8, device=x.device)
            sx_buf = torch.empty((m,), dtype=torch.float32, device=x.device)
            xa, sx = xa_buf.data_ptr(), sx_buf.data_ptr()
            plan = linear_plan(m, k, n, 1)
        else:  # the rows quantized inside the product
            plan = linear_plan(m, k, n, 1, x.element_size())
    else:
        if ln is not None:  # the normalised rows, the product's operand: float32's TF32 pair
            pair = 2 if cdt == torch.float32 else 1
            xa_buf = torch.empty((pair * m, k), dtype=cdt, device=x.device)
            xa = xa_buf.data_ptr()
        plan = linear_plan(m, k, n, w.element_size())
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
        eps, w.data_ptr(), w_s, bias.data_ptr(), out.data_ptr(), xa, sx, m, k, n,
        plan.bn, plan.splits, plan.k_slice, _build.stream_of(x),
    )
    _build.check(err, name)
    fused_linear_cuda.launches += 1
    if quant and ln is not None:
        rowquant_cuda.launches += 1
    return out


fused_linear_cuda.launches = 0


def fused_linear(x, w, bias, *, epilogue: str, ln=None, eps: float = 1e-5, residual=None,
                 w_scale=None, compute_dtype=None, use_kernel: bool | None = None):
    fn = fused_linear_cuda if _build.kernels_enabled(use_kernel, x.device) else fused_linear_plain
    return fn(x, w, bias, epilogue=epilogue, ln=ln, eps=eps, residual=residual, w_scale=w_scale,
              compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Final LN + logits + greedy argmax: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

def logits_plain(x32, lnf, wte, eps: float = 1e-5, *, wte_scale=None,
                 compute_dtype=None) -> torch.Tensor:
    """(B, V) float32 logits of the step: LN_f in float32, cast to the compute
    dtype (default wte's), times wte^T with float32 accumulation — or, with
    an int8 wte and its (V,) ``wte_scale``, the cast rows quantized and
    multiplied in int8 (:func:`ops.quant.int8_matmul`)."""
    cdt = compute_dtype or wte.dtype
    if wte_scale is not None:
        xq, sx = rowquant_plain(x32, (lnf[0], lnf[1]), eps, cdt)
        return int8_matmul(xq, sx, wte, wte_scale)
    xf = nn.layer_norm_rows(lnf[0], lnf[1], x32.float(), eps).to(cdt)
    return nn.dot_f32(xf, wte.t())


def logits_argmax_plain(x32, lnf, wte, eps: float = 1e-5, **quant) -> torch.Tensor:
    """Plain twin of ``csrc/logits_argmax.cu``: (B,) int32 greedy tokens
    (``torch.argmax`` returns the first index of the max).  ``quant``:
    ``wte_scale`` and ``compute_dtype`` as in :func:`logits_plain`."""
    return torch.argmax(logits_plain(x32, lnf, wte, eps, **quant), dim=-1).to(torch.int32)


def logits_argmax_cuda(x32, lnf, wte, eps: float = 1e-5, *, wte_scale=None,
                       compute_dtype=None) -> torch.Tensor:
    """Launch ``csrc/logits_argmax.cu``.  x32: (B, D) float32 residual stream;
    lnf: (2, D) float32 LN_f scale and bias; wte: (V, D) in the compute dtype,
    or int8 with its (V,) float32 ``wte_scale`` (the rows are then quantized
    inside the call); ``compute_dtype`` defaults to wte's.  Returns (B,)
    int32."""
    name = "logits_argmax"
    cdt, xf, sx, ws = _vocab_args(name, x32, lnf, wte, wte_scale, compute_dtype)
    b, d = x32.shape
    v = wte.shape[0]
    nblk, _ = vocab_partials("argmax", b, v)
    part_val = torch.empty((b, nblk), dtype=torch.float32, device=x32.device)
    part_idx = torch.empty((b, nblk), dtype=torch.int32, device=x32.device)
    tok = torch.empty((b,), dtype=torch.int32, device=x32.device)
    err = _build.library().gic_logits_argmax(
        _build.DTYPE_CODE[cdt], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), _build.ptr(ws), b, d, v, nblk, xf.data_ptr(), _build.ptr(sx),
        part_val.data_ptr(), part_idx.data_ptr(), tok.data_ptr(), _build.stream_of(x32),
    )
    _count_vocab(logits_argmax_cuda, name, err, ws)
    return tok


logits_argmax_cuda.launches = 0


def logits_argmax(x32, lnf, wte, eps: float = 1e-5, *, use_kernel: bool | None = None, **quant):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_argmax_cuda(x32, lnf, wte, eps, **quant)
    return logits_argmax_plain(x32, lnf, wte, eps, **quant)


def _vocab_check(name, x32, lnf, wte, wte_scale, compute_dtype) -> torch.dtype:
    """The argument checks the four vocabulary kernels share, short of the
    device (so a CPU call shows them too).  Returns the compute dtype."""
    quant = wte_scale is not None
    cdt = compute_dtype or wte.dtype
    _build.require(cdt in _build.DTYPE_CODE, name, f"unsupported compute dtype {cdt}")
    _build.require(wte.dtype == (torch.int8 if quant else cdt), name,
                   "wte must be int8 with wte_scale, else the compute dtype")
    d = x32.shape[1]
    v = wte.shape[0]
    _build.require(x32.dtype == torch.float32 and x32.is_contiguous(), name,
                   "x32 must be contiguous float32")
    _build.require(wte.shape[1] == d and wte.is_contiguous(), name,
                   "wte must be contiguous (V, D)")
    _build.require(d % (16 // wte.element_size()) == 0 and x32.data_ptr() % 16 == 0
                   and wte.data_ptr() % 16 == 0, name,
                   "D must be a multiple of 16 (int8), 8 (bf16) or 4 (float32), x32 and wte "
                   "16-byte aligned")
    _build.require(lnf.shape == (2, d) and lnf.dtype == torch.float32 and lnf.is_contiguous(), name,
                   "lnf must be contiguous float32 (2, D)")
    for t in (lnf, wte):
        _build.require(t.device == x32.device, name, "all tensors must be on one device")
    if quant:
        _build.require(wte_scale.shape == (v,) and wte_scale.dtype == torch.float32
                       and wte_scale.is_contiguous() and wte_scale.device == x32.device, name,
                       "wte_scale must be contiguous float32 (V,) on x32's device")
    return cdt


def _vocab_scratch(name, x32, wte_scale, cdt):
    """The device check, then the scratch of the normalised rows — (B, D) in
    the compute dtype, int8 with an int8 wte, (2, B, D) for the float32 walk
    (the rows' TF32 hi and lo parts) — and the (B,) scratch of the rows'
    scales (None for a float wte)."""
    _build.require(x32.is_cuda, name, "x32 must be a CUDA tensor")
    b, d = x32.shape
    if wte_scale is None:
        shape = (2, b, d) if cdt == torch.float32 else (b, d)
        return torch.empty(shape, dtype=cdt, device=x32.device), None
    return (torch.empty((b, d), dtype=torch.int8, device=x32.device),
            torch.empty((b,), dtype=torch.float32, device=x32.device))


def _vocab_args(name, x32, lnf, wte, wte_scale, compute_dtype):
    """:func:`_vocab_check` and :func:`_vocab_scratch`: the compute dtype,
    the two scratch tensors and ``wte_scale``."""
    cdt = _vocab_check(name, x32, lnf, wte, wte_scale, compute_dtype)
    return (cdt, *_vocab_scratch(name, x32, wte_scale, cdt), wte_scale)


def _count_vocab(wrapper, name, err, wte_scale) -> None:
    """Raise on a failed launch, else count the wrapper's call, and the row
    quantizer's launch inside it for an int8 wte."""
    _build.check(err, name)
    wrapper.launches += 1
    if wte_scale is not None:
        rowquant_cuda.launches += 1


# ---------------------------------------------------------------------------
# Final LN + logits stored (emit_logits): kernel, dispatcher (twin: logits_plain)
# ---------------------------------------------------------------------------

def logits_cuda(x32, lnf, wte, eps: float = 1e-5, *, wte_scale=None,
                compute_dtype=None) -> torch.Tensor:
    """Launch ``csrc/logits.cu``: the (B, V) float32 logits of
    :func:`logits_plain`.  Arguments as :func:`logits_argmax_cuda`."""
    name = "logits"
    cdt, xf, sx, ws = _vocab_args(name, x32, lnf, wte, wte_scale, compute_dtype)
    b, d = x32.shape
    v = wte.shape[0]
    out = torch.empty((b, v), dtype=torch.float32, device=x32.device)
    err = _build.library().gic_logits(
        _build.DTYPE_CODE[cdt], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), _build.ptr(ws), b, d, v, vocab_plan(b, v).ranges, xf.data_ptr(),
        _build.ptr(sx), out.data_ptr(), _build.stream_of(x32),
    )
    _count_vocab(logits_cuda, name, err, ws)
    return out


logits_cuda.launches = 0


def logits(x32, lnf, wte, eps: float = 1e-5, *, use_kernel: bool | None = None, **quant):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_cuda(x32, lnf, wte, eps, **quant)
    return logits_plain(x32, lnf, wte, eps, **quant)


# ---------------------------------------------------------------------------
# Final LN + logits → per-row top-k and logsumexp: kernel, plain twin, dispatcher
# ---------------------------------------------------------------------------

TOPK_MAX = 16  # csrc/logits_topk.cu kMaxK

# The vocabulary walk (csrc/vocab_walk.cuh) of the four vocabulary kernels,
# in every operand type
VOCAB_BN = 128         # vocab_walk.cuh VW_BN: vocabulary columns a tile
_RING_BUDGET = 192 * 1024  # vocab_walk.cuh VW_RING_BUDGET: bytes of a block's ring
_RING_STAGES = 8           # vocab_walk.cuh VW_MAX_STAGES
_TMA_BOX = 128             # common.cuh kTmaBox: bytes of K a box
_STORE_STAGING = 8 * 16 * 40 * 4  # logits.cu kStageBytes: the store's staging


class VocabPlan(NamedTuple):
    rows: int         # rows a block: 64 a consumer warpgroup
    row_tiles: int
    tiles: int        # VOCAB_BN-wide column tiles
    ranges: int       # column ranges: the blocks of a row tile, a partial a row each
    rare_ranges: int  # the same in the sampler's passes after round 1's verification

    @staticmethod
    def span(tiles: int, ranges: int, r: int) -> tuple[int, int]:
        """Range r's column tiles [lo, hi) of ``ranges``, as the kernels cut
        them."""
        return tiles * r // ranges, tiles * (r + 1) // ranges


@functools.lru_cache(maxsize=None)
def vocab_plan(m: int, v: int) -> VocabPlan:
    """The grid the walk of ``csrc/vocab_walk.cuh`` runs M rows over a V-column
    vocabulary in: row tiles of 128 rows (64 where M <= 64), and for each as
    many contiguous column ranges as give a block an SM (one at most per
    tile), balanced to one tile.  The sampler's passes after round 1's
    verification walk only for the rows it left unresolved, so each row tile
    spreads over as many ranges as a full pass has blocks
    (``csrc/logits_sample.cu::rare_ranges``)."""
    rows = 64 if m <= 64 else 128
    row_tiles = -(-m // rows)
    tiles = -(-v // VOCAB_BN)
    ranges = max(1, min(tiles, SMS // row_tiles))
    return VocabPlan(rows, row_tiles, tiles, ranges, min(tiles, row_tiles * ranges))


def vocab_ring(rows: int, element_size: int, store: bool = False) -> tuple[int, int]:
    """(stages, dynamic shared memory bytes) of a walk block of ``rows`` rows
    (64 or 128) over operands of ``element_size`` bytes, as
    ``csrc/vocab_walk.cuh::vw_stages`` / ``vw_smem`` size them: a stage holds
    a 128-byte box of the rows and one of VOCAB_BN wte rows — each twice in
    float32, its TF32 hi and lo parts —, as many stages as the ring's budget
    holds (at most 8), and 1,024 bytes for alignment; with ``store`` also
    ``csrc/logits.cu``'s staging (a 16 x 40-float slot for each of 8 warps)."""
    stage = (rows + VOCAB_BN) * _TMA_BOX * (2 if element_size == 4 else 1)
    stages = min(_RING_STAGES, _RING_BUDGET // stage)
    return stages, 1024 + stages * stage + store * _STORE_STAGING


def vocab_partials(kernel: str, m: int, v: int) -> tuple[int, int]:
    """(blocks a row, partials a row) of ``kernel`` ("argmax", "topk" or
    "sample") in every operand type: the blocks its C entry takes and
    checks, the walk's ranges, and the partials its scratch holds for a
    row, the most any of its passes writes (the sampler's rare passes)."""
    plan = vocab_plan(m, v)
    return plan.ranges, plan.rare_ranges if kernel == "sample" else plan.ranges


def logits_topk_plain(x32, lnf, wte, k: int, eps: float = 1e-5, **quant):
    """Plain twin of ``csrc/logits_topk.cu``: :func:`logits_plain`, then
    :func:`ops.sampling.topk_small` and the logsumexp.  Returns (values (B, k)
    float32, ids (B, k) int32, lse (B, 1) float32)."""
    lg = logits_plain(x32, lnf, wte, eps, **quant)
    vals, ids = topk_small(lg, k)
    return vals, ids, torch.logsumexp(lg, dim=-1, keepdim=True)


def logits_topk_cuda(x32, lnf, wte, k: int, eps: float = 1e-5, *, wte_scale=None,
                     compute_dtype=None):
    """Launch ``csrc/logits_topk.cu``: :func:`logits_topk_plain`'s outputs,
    the (B, V) logits never stored.  Arguments as :func:`logits_argmax_cuda`;
    1 <= k <= min(16, V)."""
    name = "logits_topk"
    v = wte.shape[0]
    _build.require(1 <= k <= min(TOPK_MAX, v), name, f"k must be in [1, {min(TOPK_MAX, v)}]")
    cdt, xf, sx, ws = _vocab_args(name, x32, lnf, wte, wte_scale, compute_dtype)
    b, d = x32.shape
    nblk, _ = vocab_partials("topk", b, v)
    dev = x32.device
    part_val = torch.empty((b, nblk, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, nblk, k), dtype=torch.int32, device=dev)
    part_m = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    part_s = torch.empty((b, nblk), dtype=torch.float32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    lse = torch.empty((b, 1), dtype=torch.float32, device=dev)
    err = _build.library().gic_logits_topk(
        _build.DTYPE_CODE[cdt], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), _build.ptr(ws), b, d, v, k, nblk, xf.data_ptr(), _build.ptr(sx),
        part_val.data_ptr(), part_idx.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), lse.data_ptr(), _build.stream_of(x32),
    )
    _count_vocab(logits_topk_cuda, name, err, ws)
    return vals, ids, lse


logits_topk_cuda.launches = 0


def logits_topk(x32, lnf, wte, k: int, eps: float = 1e-5, *, use_kernel: bool | None = None,
                **quant):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_topk_cuda(x32, lnf, wte, k, eps, **quant)
    return logits_topk_plain(x32, lnf, wte, k, eps, **quant)


# ---------------------------------------------------------------------------
# Final LN + logits → per-row temperature / top-p draw (sample): kernel,
# dispatcher (twin: ops.sampling.sample_step_plain)
# ---------------------------------------------------------------------------

SAMPLE_K_MAX = 4  # csrc/logits_sample.cu kMaxCand

# The sampler's counters, one zeroed buffer a device: its kernels leave them
# zero for the next call (csrc/logits_sample.cu), so a call needs no memset.
# Calls that share a device run in stream order, as the decode step's do.
_SAMPLE_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _sample_counters(b: int, device: torch.device) -> torch.Tensor:
    """The device's counters, a row tile's ticket each: at least ceil(B / 64)
    of them; a larger buffer is made (zeroed) the first time a B needs it."""
    need = -(-b // 64)
    counters = _SAMPLE_COUNTERS.get(device)
    if counters is None or counters.numel() < need:
        counters = torch.zeros((need,), dtype=torch.int32, device=device)
        _SAMPLE_COUNTERS[device] = counters
    return counters


def logits_sample_cuda(x32, lnf, wte, temp, top_p, seed: int, k: int = 3, rounds: int = 6,
                       eps: float = 1e-5, *, wte_scale=None, compute_dtype=None):
    """Launch ``csrc/logits_sample.cu``: :func:`ops.sampling.sample_step_plain`'s
    outputs, (token (B,) int32, round (B,) int32, lse (B, 1) float32), the
    (B, V) logits never stored.  Arguments as :func:`logits_argmax_cuda`;
    temp, top_p (B,) float32 on the same device; ``seed`` a 64-bit int keying
    the kernel's Philox; 1 <= k <= 4; rounds >= 0.  2 + 2 rounds CUDA
    launches, none of which the host waits for."""
    name = "logits_sample"
    _build.require(1 <= k <= SAMPLE_K_MAX, name, f"k must be in [1, {SAMPLE_K_MAX}]")
    _build.require(rounds >= 0, name, "rounds must be >= 0")
    cdt = _vocab_check(name, x32, lnf, wte, wte_scale, compute_dtype)
    b, d = x32.shape
    v = wte.shape[0]
    for t in (temp, top_p):
        _build.require(t.shape == (b,) and t.dtype == torch.float32 and t.is_contiguous()
                       and t.device == x32.device, name,
                       "temp and top_p must be contiguous float32 (B,) on x32's device")
    xf, sx = _vocab_scratch(name, x32, wte_scale, cdt)
    ws = wte_scale
    ncb, parts = vocab_partials("sample", b, v)
    dev = x32.device
    part_f = torch.empty((b * parts * (3 + 3 * k),), dtype=torch.float32, device=dev)
    part_i = torch.empty((b * parts * (1 + k),), dtype=torch.int32, device=dev)
    state_i = torch.empty((b * (1 + k),), dtype=torch.int32, device=dev)
    state_f = torch.empty((b * k,), dtype=torch.float32, device=dev)
    counters = _sample_counters(b, dev)
    tok = torch.empty((b,), dtype=torch.int32, device=dev)
    rnd = torch.empty((b,), dtype=torch.int32, device=dev)
    lse = torch.empty((b, 1), dtype=torch.float32, device=dev)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    err = _build.library().gic_logits_sample(
        _build.DTYPE_CODE[cdt], x32.data_ptr(), lnf[0].data_ptr(), lnf[1].data_ptr(), eps,
        wte.data_ptr(), _build.ptr(ws), b, d, v, temp.data_ptr(), top_p.data_ptr(),
        seed & 0xFFFFFFFF, seed >> 32, k, rounds, ncb, xf.data_ptr(), _build.ptr(sx),
        part_f.data_ptr(), part_i.data_ptr(), state_i.data_ptr(), state_f.data_ptr(),
        counters.data_ptr(), tok.data_ptr(), rnd.data_ptr(), lse.data_ptr(), _build.stream_of(x32),
    )
    if err:  # a pass that never ran leaves its counts behind
        counters.zero_()
    _count_vocab(logits_sample_cuda, name, err, ws)
    return tok, rnd, lse


logits_sample_cuda.launches = 0


def logits_sample(x32, lnf, wte, temp, top_p, seed: int, k: int = 3, rounds: int = 6,
                  eps: float = 1e-5, *, use_kernel: bool | None = None, **quant):
    if _build.kernels_enabled(use_kernel, x32.device):
        return logits_sample_cuda(x32, lnf, wte, temp, top_p, seed, k, rounds, eps, **quant)
    return sample_step_plain(x32, lnf, wte, temp, top_p, seed, k, rounds, eps=eps, **quant)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def decode_layers(packed, x0, k_cache, v_cache, idx: int, *, n_head: int, eps: float = 1e-5,
                  origin=None, gather_start: int = 0, start=None, k_scale=None, v_scale=None,
                  use_kernels: bool | None = None) -> torch.Tensor:
    """All layers of one step: returns the (B, D) float32 residual stream
    before the final LN.  Appends each layer's K/V at ``idx`` in place (and,
    for int8 caches, its scales into ``k_scale``/``v_scale`` (L, T, B));
    ``origin``/``gather_start``/``start`` as in
    :func:`ops.decode_attention.decode_attention`.  An int8 pack (``qkvs``)
    runs every projection in W8A8."""
    d = x0.shape[1]
    cdt = x0.dtype
    quant = "qkvs" in packed
    x32 = x0.to(torch.float32, copy=True)

    def linear(x, role, bias, l, **kw):
        scale = packed[role[:-1] + "s"][l] if quant else None
        return fused_linear(x, packed[role][l], packed[bias][l], eps=eps, w_scale=scale,
                            compute_dtype=cdt if quant else None, use_kernel=use_kernels, **kw)

    for l in range(k_cache.shape[0]):
        qkv = linear(x32, "qkvw", "attnb", l, epilogue="cast",
                     ln=(packed["ln1s"][l], packed["ln1b"][l]))
        cache_scales = {} if k_scale is None else {"k_scale": k_scale[l], "v_scale": v_scale[l]}
        a, _, _ = decode_attention(
            qkv[:, :d], qkv[:, d : 2 * d], qkv[:, 2 * d :], k_cache[l], v_cache[l], idx,
            n_head=n_head, origin=origin, gather_start=gather_start, start=start,
            use_kernel=use_kernels, **cache_scales,
        )
        linear(a, "projw", "projb", l, epilogue="residual", residual=x32)
        h = linear(x32, "fcw", "fcb", l, epilogue="gelu", ln=(packed["ln2s"][l], packed["ln2b"][l]))
        linear(h, "cprojw", "cprojb", l, epilogue="residual", residual=x32)
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

    W8A8: a pack from ``pack_decode_weights(quant=True)`` (it holds ``qkvs``)
    runs every projection and the vocabulary in int8, in every mode.  int8
    KV cache: int8 caches with ``k_scale``/``v_scale`` (L, Tpad, B) float32
    per-row scales (:func:`ops.quant.quantize_cache`); the step writes row
    ``idx``'s scales in place and the return tuple ends with ``k_scale,
    v_scale``.  As in the JAX package it has no ``topk`` or ``sample``
    variant.  ``use_kernels=False`` is the step's plain twin.
    """
    cache_quant = k_cache.dtype == torch.int8
    if sample is not None and (topk or emit_logits or beam_k):
        raise ValueError("sample mode is exclusive with topk/emit_logits/beam")
    if start is not None and origin is not None:
        raise ValueError("start and origin are exclusive (beam search never passes a start)")
    if cache_quant != (k_scale is not None) or cache_quant != (v_scale is not None):
        raise ValueError("an int8 KV cache needs k_scale and v_scale, and only it takes them")
    if cache_quant and topk:
        raise ValueError("beam top-k mode has no int8-cache variant")
    if cache_quant and sample is not None:
        raise ValueError("sample mode has no int8-cache variant")
    if (origin is None) != (beam_k == 0):
        raise ValueError("beam mode needs origin and beam_k together")
    if topk and emit_logits:
        raise ValueError("topk and emit_logits are exclusive")
    if beam_k and x0.shape[0] % beam_k:
        raise ValueError(f"batch {x0.shape[0]} is not a whole number of beam groups of {beam_k}")
    use = fused_greedy_enabled(use_kernels, x0.device)
    x32 = decode_layers(packed, x0, k_cache, v_cache, int(idx), n_head=n_head, eps=eps,
                        origin=origin, gather_start=gather_start, start=start, k_scale=k_scale,
                        v_scale=v_scale, use_kernels=use)
    lnf, wte = packed["lnf"], packed["wte"]
    quant = {"wte_scale": packed["wtes"], "compute_dtype": x0.dtype} if "qkvs" in packed else {}
    caches = (k_cache, v_cache) + ((k_scale, v_scale) if cache_quant else ())
    if sample is not None:
        b = x0.shape[0]
        temp = torch.as_tensor(sample["temp"], dtype=torch.float32, device=x0.device).reshape(b)
        top_p = torch.as_tensor(sample["top_p"], dtype=torch.float32, device=x0.device).reshape(b)
        tok, rnd, lse = logits_sample(x32, lnf, wte, temp.contiguous(), top_p.contiguous(),
                                      int(sample["seed"]), sample_k, sample_rounds, eps,
                                      use_kernel=use, **quant)
        return tok, rnd, lse, *caches
    if topk:
        return (*logits_topk(x32, lnf, wte, topk, eps, use_kernel=use, **quant), *caches)
    if emit_logits:
        return logits(x32, lnf, wte, eps, use_kernel=use, **quant), *caches
    return logits_argmax(x32, lnf, wte, eps, use_kernel=use, **quant), *caches
