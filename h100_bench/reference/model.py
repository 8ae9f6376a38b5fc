"""The plain reference: ClipCap's models in plain PyTorch, float32, no kernel,
no cache, no batching tricks.  It imports nothing of the port; it reads the
benchmark's own parameter trees (the layouts of ``h100_bench/weights.py``,
which follow the published checkpoints' tensors):

- CLIP ViT-B/32's vision tower (Radford et al. 2021; HF ``CLIPVisionModel``
  + ``visual_projection``): pixels scaled to [0, 1] and normalised by CLIP's
  mean and std, a stride-32 convolution without bias (here the product of
  the unfolded (c, y, x) patches with the (3·32·32, D) weight), CLS and
  learned positions, a pre-LayerNorm, pre-norm layers (quick-GELU MLP), the
  post-LayerNorm of CLS, the projection, L2 normalisation.
- ClipCap's transformer mapper (Mokady et al. 2021, ``TransformerMapper``,
  as ``config.yml`` sets it): a linear map of the embedding to
  ``hidden_length`` tokens, a learned constant of ``prefix_length`` tokens
  after them, pre-norm encoder layers (bidirectional attention, ReLU MLP of
  4·D, no final norm); the last ``prefix_length`` tokens are the prefix.
- GPT-2 (Radford et al. 2019; HF ``GPT2LMHeadModel``): token and position
  embeddings, pre-norm blocks with causal attention and a tanh-GELU MLP,
  the final LayerNorm, logits against the tied token embedding.
- The captioning loss (mean cross entropy over the caption's labelled
  positions, the prefix predicting the first token) and AdamW with
  decoupled weight decay (Loshchilov & Hutter 2019, PyTorch's ``AdamW``),
  after clipping the gradients' global norm (``clip_grad_norm_``).

Departures from the published code: none in the equations; the mapper's
attention takes the combined q/k/v weight of ``nn.MultiheadAttention`` in
the (in, out) layout, and every product is written as ``x @ W`` with W
stored (in, out).

Every product goes through :meth:`Precision.mm`: float32 with TF32 off
(``exact``), or with the operands first rounded to TF32 (``tf32``) or to
fp8 e4m3 with a per-tensor scale (``fp8``), the lower precisions whose
results are the controls of ``correct``.
"""

from __future__ import annotations

import math

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def exact_float32() -> None:
    """Turn TF32 off for every float32 product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 values through fp8 e4m3 with one scale for the tensor."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """How the reference's products round their operands: ``exact``
    (float32), ``tf32`` or ``fp8``."""

    ROUND = {"exact": lambda t: t.float(), "tf32": round_tf32, "fp8": round_fp8}

    def __init__(self, name: str = "exact"):
        if name not in self.ROUND:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self._round = self.ROUND[name]

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in float32 from rounded operands (``b`` may be batched)."""
        return torch.matmul(self._round(a), self._round(b))


EXACT = Precision("exact")


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                                          p["bias"].float(), eps)


def linear(x: torch.Tensor, p: dict, prec: Precision) -> torch.Tensor:
    y = prec.mm(x, p["w"].float())
    return y + p["b"].float() if "b" in p else y


def heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n, d // n).transpose(1, 2)


def merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attention(q, k, v, prec: Precision, causal: bool = False,
              key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(hd)) v over (B, H, T, hd); ``key_mask`` (B, T)
    is 1 where a key may be attended."""
    t_q, t_k = q.shape[2], k.shape[2]
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    allowed = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device)
    if causal:
        allowed = torch.tril(allowed, diagonal=t_k - t_q)
    allowed = allowed[None, None]
    if key_mask is not None:
        allowed = allowed & key_mask.bool()[:, None, None, :]
    s = s.masked_fill(~allowed, float("-inf"))
    return prec.mm(torch.softmax(s, dim=-1), v)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked on a leading layer dim."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# CLIP ViT-B/32's vision tower
# ---------------------------------------------------------------------------

def clip_image_embeddings(tower: dict, vcfg: dict, pixels: torch.Tensor,
                          prec: Precision = EXACT) -> torch.Tensor:
    """uint8 (B, S, S, 3) pixels → L2-normalised (B, projection_dim)."""
    b, s = pixels.shape[:2]
    p, d = vcfg["patch_size"], vcfg["hidden_size"]
    mean = torch.tensor(CLIP_MEAN, device=pixels.device)
    std = torch.tensor(CLIP_STD, device=pixels.device)
    x = (pixels.float() / 255.0 - mean) / std                    # (B, S, S, 3)
    g = s // p
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4)     # (B, gy, gx, c, py, px)
    x = prec.mm(x.reshape(b, g * g, 3 * p * p), tower["patch_embedding"].float())
    cls = tower["class_embedding"].float().expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + tower["position_embedding"].float()[None]
    eps = vcfg["layer_norm_eps"]
    x = layer_norm(x, tower["pre_layernorm"], eps)
    n = vcfg["num_attention_heads"]
    for i in range(vcfg["num_hidden_layers"]):
        lp = layer(tower["layers"], i)
        h = layer_norm(x, lp["ln1"], eps)
        q, k, v = (heads(linear(h, lp["attn"][w], prec), n) for w in "qkv")
        x = x + linear(merge(attention(q, k, v, prec)), lp["attn"]["out"], prec)
        h = layer_norm(x, lp["ln2"], eps)
        h = linear(h, lp["mlp"]["fc1"], prec)
        x = x + linear(h * torch.sigmoid(1.702 * h), lp["mlp"]["fc2"], prec)
    pooled = layer_norm(x[:, 0], tower["post_layernorm"], eps)
    feats = prec.mm(pooled, tower["visual_projection"]["w"].float())
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# ClipCap's transformer mapper
# ---------------------------------------------------------------------------

def mapper(mp: dict, mcfg: dict, emb: torch.Tensor, prec: Precision = EXACT) -> torch.Tensor:
    """(B, embed_dim) → (B, prefix_length, gpt_dim)."""
    b, d = emb.shape[0], mcfg["gpt_dim"]
    img = linear(emb.float(), mp["linear"], prec).reshape(b, mcfg["hidden_length"], d)
    const = mp["prefix_const"].float().expand(b, mcfg["prefix_length"], d)
    x = torch.cat([img, const], dim=1)
    eps, n = mcfg["layer_norm_eps"], mcfg["num_heads"]
    for lp in mp["layers"]:
        h = layer_norm(x, lp["ln1"], eps)
        q, k, v = torch.split(linear(h, lp["attn"]["in_proj"], prec), d, dim=-1)
        a = attention(heads(q, n), heads(k, n), heads(v, n), prec)
        x = x + linear(merge(a), lp["attn"]["out_proj"], prec)
        h = layer_norm(x, lp["ln2"], eps)
        x = x + linear(torch.relu(linear(h, lp["fc1"], prec)), lp["fc2"], prec)
    return x[:, mcfg["hidden_length"]:]


# ---------------------------------------------------------------------------
# GPT-2
# ---------------------------------------------------------------------------

def gpt2_hidden(gpt: dict, gcfg: dict, embeds: torch.Tensor,
                key_mask: torch.Tensor | None = None, prec: Precision = EXACT) -> torch.Tensor:
    """Input embeddings (B, T, D), positions 0 … T - 1 added → the final
    LayerNorm's hidden states (B, T, D)."""
    t = embeds.shape[1]
    x = embeds.float() + gpt["wpe"][:t].float()[None]
    eps, n = gcfg["layer_norm_epsilon"], gcfg["n_head"]
    for i in range(gcfg["n_layer"]):
        bp = layer(gpt["blocks"], i)
        h = layer_norm(x, bp["ln_1"], eps)
        q, k, v = torch.split(linear(h, bp["attn"]["c_attn"], prec), x.shape[-1], dim=-1)
        a = attention(heads(q, n), heads(k, n), heads(v, n), prec, causal=True,
                      key_mask=key_mask)
        x = x + linear(merge(a), bp["attn"]["c_proj"], prec)
        h = layer_norm(x, bp["ln_2"], eps)
        x = x + linear(gelu_tanh(linear(h, bp["mlp"]["c_fc"], prec)), bp["mlp"]["c_proj"], prec)
    return layer_norm(x, gpt["ln_f"], eps)


def logits(gpt: dict, hidden: torch.Tensor, prec: Precision = EXACT) -> torch.Tensor:
    """Logits against the tied token embedding."""
    return prec.mm(hidden, gpt["wte"].float().t())


def caption_logits(mp: dict, gpt: dict, cfg: dict, emb: torch.Tensor, tokens: torch.Tensor,
                   prec: Precision = EXACT) -> torch.Tensor:
    """Teacher-forced logits (B, n, V) of ``tokens`` (B, n): position j
    predicts token j from the image's prefix and tokens 0 … j - 1."""
    prefix = mapper(mp, cfg["mapping"], emb, prec)
    n = tokens.shape[1]
    words = gpt["wte"][tokens[:, : n - 1].long()].float()
    hidden = gpt2_hidden(gpt, cfg["gpt2"], torch.cat([prefix, words], dim=1), prec=prec)
    p = prefix.shape[1]
    return logits(gpt, hidden[:, p - 1:], prec)


# ---------------------------------------------------------------------------
# Training: the caption loss and AdamW
# ---------------------------------------------------------------------------

def caption_loss(mp: dict, gpt: dict, cfg: dict, batch: dict,
                 prec: Precision = EXACT) -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` (-100: not counted) given
    the image prefix and the caption ``token_ids`` behind it; the caption's
    ``attention_mask`` masks padding keys."""
    prefix = mapper(mp, cfg["mapping"], batch["image_embedding"], prec)
    words = gpt["wte"][batch["token_ids"].long()].float()
    p = prefix.shape[1]
    ones = torch.ones((prefix.shape[0], p), dtype=batch["attention_mask"].dtype,
                      device=prefix.device)
    mask = torch.cat([ones, batch["attention_mask"]], dim=1)
    hidden = gpt2_hidden(gpt, cfg["gpt2"], torch.cat([prefix, words], dim=1), mask, prec)
    h = hidden[:, p - 1:-1].reshape(-1, hidden.shape[-1])
    labels = batch["labels"].reshape(-1).long()
    keep = labels != -100
    lg = logits(gpt, h[keep], prec)
    return torch.nn.functional.cross_entropy(lg, labels[keep])


def clip_gradients(grads: list[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """Scale the gradients by min(1, max_norm / (global norm + 1e-6))."""
    norm = torch.sqrt(sum(torch.square(g.double()).sum() for g in grads))
    scale = min(1.0, max_norm / (float(norm) + 1e-6))
    return [g * scale for g in grads]


def adamw_update(params: list[torch.Tensor], grads: list[torch.Tensor], state: dict,
                 lr: float, beta1: float, beta2: float, eps: float, weight_decay: float
                 ) -> None:
    """One AdamW step in place: p ← p·(1 − lr·wd) − lr·m̂ / (sqrt(v̂) + eps)."""
    state["step"] = state.get("step", 0) + 1
    t = state["step"]
    ms, vs = state.setdefault("m", [torch.zeros_like(p) for p in params]), \
        state.setdefault("v", [torch.zeros_like(p) for p in params])
    for p, g, m, v in zip(params, grads, ms, vs):
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        m_hat = m / (1 - beta1 ** t)
        v_hat = v / (1 - beta2 ** t)
        p.mul_(1 - lr * weight_decay)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
