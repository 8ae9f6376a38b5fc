"""Functional neural-net building blocks over plain dicts of tensors.

The PyTorch counterpart of ``gpt2_image_captioning_tpu/ops/nn.py``: the same
parameter layouts (``Conv1D``-style ``(in, out)`` matmul weights, LayerNorm
``scale``/``bias``) and the same numerics.  Every matmul takes its inputs in
the policy's compute dtype and accumulates in float32, as the JAX package's
``preferred_element_type=jnp.float32`` does (:func:`dot_f32`).
"""

from __future__ import annotations

import math

import torch

from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy

NEG_INF = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; draws differ from jax.random)
# ---------------------------------------------------------------------------

def normal(generator: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator, dtype=torch.float32)


def uniform(generator: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def dense_init(
    generator: torch.Generator, in_dim: int, out_dim: int, *, std: float | None = 0.02,
    bias: bool = True,
) -> dict:
    """Weights stored ``(in, out)``.  ``std=None`` selects torch ``nn.Linear``'s
    default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""
    if std is None:
        bound = 1.0 / math.sqrt(in_dim)
        p = {"w": uniform(generator, (in_dim, out_dim), bound)}
        if bias:
            p["b"] = uniform(generator, (out_dim,), bound)
    else:
        p = {"w": normal(generator, (in_dim, out_dim), std)}
        if bias:
            p["b"] = torch.zeros(out_dim)
    return p


def layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


# ---------------------------------------------------------------------------
# Dense / LayerNorm / activations
# ---------------------------------------------------------------------------

class _MatmulF32(torch.autograd.Function):
    """2-D ``a @ b`` of bf16 operands on the tensor cores with a float32
    result.  ``torch.mm(..., out_dtype=...)`` has no gradient, so the
    backward is written out: the incoming float32 gradient is rounded to the
    operands' dtype and each product accumulates in float32 again; a
    gradient is computed only for an operand that needs one (a frozen
    weight's is skipped)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (b 2-D) with float32 accumulation and a float32 result.

    On CUDA, bf16 operands go to the tensor cores with a float32 output
    (:class:`_MatmulF32`); elsewhere both operands are upcast, which gives
    the same products (a bf16 product is exact in float32) in another
    summation order."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def dense(params: dict, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    y = dot_f32(policy.cast(x), params["w"].to(policy.compute_dtype))
    if "b" in params:
        y = y + params["b"].float()
    return y.to(policy.compute_dtype)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics (biased variance, torch semantics)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def layer_norm_rows(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of float32 rows as the step kernels compute it
    (``csrc/common.cuh``: ``row_mean_rstd``, ``ln_value``): the statistics
    in float64, rounded once (mean, and rstd = 1 / sqrt(var + float32(eps))),
    so no summation order shows in them; then ((x - mean) * rstd) * scale +
    bias in float32.  Returns float32."""
    x64 = x.double()
    mean = x64.mean(dim=-1, keepdim=True)
    var = torch.square(x64 - mean).mean(dim=-1, keepdim=True)
    eps32 = float(torch.tensor(eps, dtype=torch.float32))
    rstd = (1.0 / torch.sqrt(var + eps32)).float()
    y = (x.float() - mean.float()) * rstd
    return y * scale.float() + bias.float()


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf**3)))
    return y.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (HF ViT, DINOv3)."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's x · sigmoid(1.702 x)."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (the plain formula; kept free of scaled_dot_product_attention so a
# hand-written flash kernel has a plain twin to be held to)
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) → (B, H, T, hd)"""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, hd) → (B, T, D)"""
    b, h, t, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * hd)


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    key_mask: torch.Tensor | None = None,
    q_offset: int = 0,
    policy: Policy = F32,
) -> torch.Tensor:
    """Scaled dot-product attention with a float32 softmax.

    q: (B, H, Tq, hd); k/v: (B, H, Tk, hd); key_mask: (B, Tk), 1 = attend.
    Query i attends keys <= q_offset + i when ``causal``.  Masked scores take
    the float32 minimum, as in the JAX package.
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum(
        "bhqd,bhkd->bhqk", policy.cast(q).float(), policy.cast(k).float()
    ) * scale
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    if key_mask is not None:
        scores = torch.where(key_mask[:, None, None, :].bool(), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bhkd->bhqd",
        probs.to(policy.compute_dtype).float(),
        policy.cast(v).float(),
    )
    return out.to(policy.compute_dtype)
