"""GPT-2 prefill of a fresh prefix — the counterpart of
``gpt2_image_captioning_tpu/ops/prefill_step.py`` (``fused_prefill``,
``prefill_into_cache``).

Kernel: ``csrc/prefill.cu`` (hand-written CUDA for sm_90a; its header gives
the design and the bound), the port of the JAX package's Pallas
``_prefill_kernel``: one C call runs every block over the (B·T, D)
image-major rows, seven launches a layer — LN1, the QKV product whose
epilogue writes K and V straight into the cache's (T, B, D) rows, causal
attention inside each image, the projection added into the float32
residual stream, LN2 and the MLP's two products — wrapped by
:func:`prefill_cuda`.
Plain twin: :func:`prefill_plain`, the same recipe in torch ops (the
decode step's ``fused_linear_plain`` for the four products).  Unlike the
port's eager ``gpt2.forward_cached``, whose residual stream is in the
compute dtype, both keep the residual stream in float32 across layers, as
the TPU kernel does.

:func:`prefill_into_cache` is the drop-in for ``gpt2.forward_cached`` on a
fresh cache: it adds the position embeddings, runs the prefill, and takes
the first-token logits from LN_f of the last position and one product with
wte outside the kernel, as the reference does.  It reads the float decode
pack (:func:`ops.decode_step.pack_decode_weights`); an int8 pack holds no
float weights, and its callers keep ``forward_cached`` there, as the JAX
package keeps its XLA prefill.  Prefixes of at most :data:`MAX_PREFIX`
tokens (the reference's gate, ``captioner.py:302``): the kernel refuses
longer ones, and so does the twin.
"""

from __future__ import annotations

import math

import torch

from gpt2_image_captioning_tpu_torch.core.precision import Policy
from gpt2_image_captioning_tpu_torch.ops import _build, nn
from gpt2_image_captioning_tpu_torch.ops.decode_step import fused_linear_plain

MAX_PREFIX = 32  # csrc/prefill.cu: one lane per key of an image
MAX_HEAD_DIM = 96  # csrc/prefill.cu: the attention's float tiles in 48 KB


def _check(packed: dict, x0: torch.Tensor, k_cache: torch.Tensor, n_head: int) -> None:
    name = "prefill"
    _build.require("qkvs" not in packed, name, "the prefill needs the float decode pack")
    _build.require(x0.dim() == 3, name, "x0 must be (B, T, D)")
    b, t, d = x0.shape
    _build.require(1 <= t <= MAX_PREFIX, name, f"the prefix must have 1 to {MAX_PREFIX} tokens, "
                                               f"got {t}")
    _build.require(d % n_head == 0 and d // n_head <= MAX_HEAD_DIM, name,
                   f"head dim must divide D and be <= {MAX_HEAD_DIM}")
    _build.require(k_cache.dim() == 4 and k_cache.shape[2] == b and k_cache.shape[3] == d
                   and k_cache.shape[1] >= t, name, "caches must be (L, >= T, B, D)")
    _build.require(k_cache.dtype == x0.dtype, name, "caches must be in the compute dtype")


def _attention_plain(q, k, v, n_head: int) -> torch.Tensor:
    """Causal attention inside each image, as the kernel computes it: q, k, v
    (B, T, D) in the compute dtype → (B, T, D): float32 scores scaled by
    1/sqrt(hd), a float32 softmax, p·v in float32, normalised, then cast."""
    b, t, d = q.shape
    hd = d // n_head
    qh, kh, vh = (nn.split_heads(x.float(), n_head) for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(hd))
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, nn.NEG_INF)
    p = torch.where(causal, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh) / p.sum(dim=-1, keepdim=True)
    return nn.merge_heads(out).to(q.dtype)


def prefill_plain(packed: dict, x0: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  *, n_head: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain twin of ``csrc/prefill.cu``; arguments as :func:`prefill_cuda`."""
    _check(packed, x0, k_cache, n_head)
    b, t, d = x0.shape
    x32 = x0.reshape(b * t, d).to(torch.float32, copy=True)  # the stream, updated in place
    for l in range(k_cache.shape[0]):
        qkv = fused_linear_plain(x32, packed["qkvw"][l], packed["attnb"][l], epilogue="cast",
                                 ln=(packed["ln1s"][l], packed["ln1b"][l]), eps=eps)
        q, k, v = (z.reshape(b, t, d) for z in torch.split(qkv, d, dim=-1))
        k_cache[l, :t] = k.transpose(0, 1)
        v_cache[l, :t] = v.transpose(0, 1)
        a = _attention_plain(q, k, v, n_head).reshape(b * t, d)
        fused_linear_plain(a, packed["projw"][l], packed["projb"][l], epilogue="residual",
                           residual=x32)
        h = fused_linear_plain(x32, packed["fcw"][l], packed["fcb"][l], epilogue="gelu",
                               ln=(packed["ln2s"][l], packed["ln2b"][l]), eps=eps)
        fused_linear_plain(h, packed["cprojw"][l], packed["cprojb"][l], epilogue="residual",
                           residual=x32)
    return x32.reshape(b, t, d)


def prefill_cuda(packed: dict, x0: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 *, n_head: int, eps: float = 1e-5) -> torch.Tensor:
    """Launch ``csrc/prefill.cu``: every block of GPT-2 over a fresh prefix.

    x0: (B, T, D) input embeddings (tokens + positions) in the compute dtype,
    T <= :data:`MAX_PREFIX`; ``packed``: the float decode pack in that dtype;
    k_cache/v_cache: (L, Tc, B, D) in that dtype, contiguous, Tc >= T; rows
    [0, T) of every layer are written in place.  Returns the (B, T, D)
    float32 residual stream after the last block (before LN_f)."""
    name = "prefill"
    _check(packed, x0, k_cache, n_head)
    _build.require(x0.is_cuda, name, "x0 must be a CUDA tensor")
    cdt = x0.dtype
    _build.require(cdt in _build.DTYPE_CODE, name, f"unsupported compute dtype {cdt}")
    b, t, d = x0.shape
    n_layer = k_cache.shape[0]
    shapes = {"qkvw": (n_layer, 3 * d, d), "projw": (n_layer, d, d), "fcw": (n_layer, 4 * d, d),
              "cprojw": (n_layer, d, 4 * d), "attnb": (n_layer, 3 * d), "projb": (n_layer, d),
              "fcb": (n_layer, 4 * d), "cprojb": (n_layer, d), "ln1s": (n_layer, d),
              "ln1b": (n_layer, d), "ln2s": (n_layer, d), "ln2b": (n_layer, d)}
    for key, shape in shapes.items():
        p = packed[key]
        want = cdt if key.endswith("w") else torch.float32
        _build.require(tuple(p.shape) == shape and p.dtype == want and p.is_contiguous()
                       and p.device == x0.device, name,
                       f"packed[{key!r}] must be contiguous {want} {shape} on x0's device")
    _build.require(d % (16 // x0.element_size()) == 0, name,
                   "D must be a multiple of 8 (bf16) or 4 (float32)")
    for c in (k_cache, v_cache):
        _build.require(c.shape == k_cache.shape and c.is_contiguous() and c.device == x0.device,
                       name, "k_cache and v_cache must be contiguous, of one shape, on x0's device")
    m = b * t
    dev = x0.device
    x32 = x0.reshape(m, d).to(torch.float32, copy=True)
    qbuf = torch.empty((m, d), dtype=cdt, device=dev)
    abuf = torch.empty((m, d), dtype=cdt, device=dev)
    hbuf = torch.empty((m, 4 * d), dtype=cdt, device=dev)
    err = _build.library().gic_prefill(
        _build.DTYPE_CODE[cdt], n_layer, b, t, d, n_head, eps, x32.data_ptr(),
        *(packed[key].data_ptr() for key in shapes), k_cache.data_ptr(), v_cache.data_ptr(),
        k_cache.shape[1], qbuf.data_ptr(), abuf.data_ptr(), hbuf.data_ptr(),
        _build.stream_of(x0),
    )
    _build.check(err, name)
    prefill_cuda.launches += 1
    return x32.reshape(b, t, d)


prefill_cuda.launches = 0


def fused_prefill(packed: dict, x0: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  *, n_head: int, eps: float = 1e-5, use_kernel: bool | None = None
                  ) -> torch.Tensor:
    """Every GPT-2 block over a fresh prefix: the kernel for CUDA tensors, the
    twin for CPU tensors or ``use_kernel=False``.  Returns the float32
    residual stream (B, T, D); the caches' rows [0, T) are written in place."""
    fn = prefill_cuda if _build.kernels_enabled(use_kernel, x0.device) else prefill_plain
    return fn(packed, x0, k_cache, v_cache, n_head=n_head, eps=eps)


def prefill_into_cache(packed: dict, gpt_params: dict, gpt_cfg, prefix: torch.Tensor,
                       cache: dict, policy: Policy, *, use_kernel: bool | None = None
                       ) -> tuple[torch.Tensor, dict]:
    """The drop-in for ``gpt2.forward_cached`` on a fresh cache: position
    embeddings added, :func:`fused_prefill`, then the last position's LN_f
    and one product with wte → (float32 logits (B, V), the cache with index
    T, its tensors written in place)."""
    if int(cache["index"]) != 0:
        raise ValueError("the prefill writes a fresh cache (index 0)")
    t = prefix.shape[1]
    cdt = policy.compute_dtype
    pos = gpt_params["wpe"][:t].float()
    x0 = (prefix.float() + pos[None]).to(cdt)
    x32 = fused_prefill(packed, x0, cache["k"], cache["v"], n_head=gpt_cfg.n_head,
                        eps=gpt_cfg.layer_norm_epsilon, use_kernel=use_kernel)
    x = nn.layer_norm(gpt_params["ln_f"], x32[:, -1].to(cdt).float(), gpt_cfg.layer_norm_epsilon)
    logits = nn.dot_f32(policy.cast(x), gpt_params["wte"].t().to(cdt))
    return logits, {"k": cache["k"], "v": cache["v"], "index": t}
