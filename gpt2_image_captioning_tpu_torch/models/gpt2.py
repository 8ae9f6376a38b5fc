"""GPT-2 decoder over plain dicts of tensors — the counterpart of
``gpt2_image_captioning_tpu/models/gpt2.py``.

Parameters keep the JAX package's layout: ``wte`` (V, D), ``wpe`` (P, D),
``ln_f``, and ``blocks`` stacked on a leading layer dim with ``Conv1D``
``(in, out)`` weights.  ``forward_hidden`` / ``forward`` are the
full-sequence causal forward of training; the KV cache of decoding is
(L, T, B, D) with T rounded up to :data:`ops.decode_attention.CHUNK_T`;
``forward_cached`` updates it in place and the cache's ``index`` is a host
int.  Attention goes through :func:`ops.attention.mha`: the flash kernel for
CUDA tensors unless ``use_kernels=False``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha
from gpt2_image_captioning_tpu_torch.ops.xent import IGNORE_INDEX


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def gpt2_124m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny(vocab_size: int = 293) -> "GPT2Config":
        """Small config for CPU tests."""
        return GPT2Config(vocab_size=vocab_size, n_positions=128, n_embd=32, n_layer=2, n_head=2)


def init(generator: torch.Generator, cfg: GPT2Config) -> dict:
    """HF GPT-2 init scheme, as ``gpt2.init`` in the JAX package: N(0, 0.02)
    token embeddings and weights, N(0, 0.01) positions, zero biases, residual
    projections at std 0.02 / sqrt(2 · n_layer).  Float32, on the CPU."""
    d = cfg.n_embd
    proj_std = 0.02 / (2 * cfg.n_layer) ** 0.5
    wte = nn.normal(generator, (cfg.vocab_size, d), 0.02)
    wpe = nn.normal(generator, (cfg.n_positions, d), 0.01)
    layers = []
    for _ in range(cfg.n_layer):
        layers.append({
            "ln_1": nn.layer_norm_init(d),
            "attn": {
                "c_attn": nn.dense_init(generator, d, 3 * d, std=0.02),
                "c_proj": nn.dense_init(generator, d, d, std=proj_std),
            },
            "ln_2": nn.layer_norm_init(d),
            "mlp": {
                "c_fc": nn.dense_init(generator, d, 4 * d, std=0.02),
                "c_proj": nn.dense_init(generator, 4 * d, d, std=proj_std),
            },
        })
    return {"wte": wte, "wpe": wpe, "ln_f": nn.layer_norm_init(d), "blocks": stack_blocks(layers)}


def stack_blocks(blocks: list[dict]) -> dict:
    """List of per-layer param dicts → one dict with a leading layer dim."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def embed_tokens(params: dict, token_ids: torch.Tensor) -> torch.Tensor:
    return params["wte"][token_ids]


# ---------------------------------------------------------------------------
# Full-sequence forward (teacher forcing)
# ---------------------------------------------------------------------------

def _block(bp: dict, cfg: GPT2Config, x: torch.Tensor, key_mask: torch.Tensor | None,
           policy: Policy, use_kernels: bool | None) -> torch.Tensor:
    d = x.shape[-1]
    h = nn.layer_norm(bp["ln_1"], x, cfg.layer_norm_epsilon)
    qkv = nn.dense(bp["attn"]["c_attn"], h, policy)
    q, k, v = (nn.split_heads(t, cfg.n_head) for t in torch.split(qkv, d, dim=-1))
    a = mha(q, k, v, causal=True, key_mask=key_mask, policy=policy, use_kernel=use_kernels)
    x = x + nn.dense(bp["attn"]["c_proj"], nn.merge_heads(a), policy)
    h = nn.layer_norm(bp["ln_2"], x, cfg.layer_norm_epsilon)
    h = nn.gelu_new(nn.dense(bp["mlp"]["c_fc"], h, policy))
    return x + nn.dense(bp["mlp"]["c_proj"], h, policy)


def forward_hidden(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    policy: Policy = F32,
    remat: bool = False,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Full-sequence causal forward → final-LayerNorm hidden states (B, T, D)
    in the compute dtype.  ``attention_mask``: (B, T) key padding mask,
    1 = attend; positions are absolute from 0.

    ``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): the backward recomputes the block instead of keeping its
    activations, for identical loss and gradients.  Frozen weights need no
    unrolled loop as in the JAX package: tensors with ``requires_grad=False``
    get no weight gradients."""
    t = inputs_embeds.shape[1]
    pos = params["wpe"][:t].float()
    x = (inputs_embeds.float() + pos[None]).to(policy.compute_dtype)
    for i in range(cfg.n_layer):
        bp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block, bp, cfg, x, attention_mask, policy, use_kernels,
                           use_reentrant=False)
        else:
            x = _block(bp, cfg, x, attention_mask, policy, use_kernels)
    return nn.layer_norm(params["ln_f"], x, cfg.layer_norm_epsilon)


def forward(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    policy: Policy = F32,
) -> torch.Tensor:
    """Full-sequence causal LM forward over embeddings → float32 logits (B, T, V)."""
    x = forward_hidden(params, cfg, inputs_embeds, attention_mask, policy)
    return nn.dot_f32(policy.cast(x), params["wte"].t().to(policy.compute_dtype))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted next-token CE with -100 ignored → (sum, count), so callers can
    combine micro-batches before dividing.  The oracle of ``ops.xent.xent_sum``."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0).long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


# ---------------------------------------------------------------------------
# KV-cached decode
# ---------------------------------------------------------------------------

def init_cache(cfg: GPT2Config, batch: int, max_len: int, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> dict:
    """KV cache laid out (L, T, B, D), T rounded up to ``CHUNK_T``; rows past
    ``index`` are masked everywhere."""
    max_len = -(-max_len // DA.CHUNK_T) * DA.CHUNK_T
    shape = (cfg.n_layer, max_len, batch, cfg.n_embd)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "index": 0,
    }


def forward_cached(
    params: dict,
    cfg: GPT2Config,
    inputs_embeds: torch.Tensor,
    cache: dict,
    policy: Policy = F32,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, dict]:
    """Forward ``inputs_embeds`` (B, T, D) from position ``cache['index']``;
    returns (last-position float32 logits (B, V), cache with index + T).

    T > 1 is the prefill of an empty cache (the prefix attends itself
    causally through :func:`ops.attention.mha`, as the JAX package's
    ``fresh_prefill``); T == 1 is a decode step whose attention goes through
    :func:`ops.decode_attention.decode_attention`.  Both run their kernels
    for CUDA tensors unless ``use_kernels=False``.  The cache tensors are
    written in place.
    """
    _, t, d = inputs_embeds.shape
    idx = int(cache["index"])
    if t > 1 and idx != 0:
        raise ValueError(
            f"a {t}-token forward needs an empty cache (index {idx}); only the prefill of a "
            "fresh cache and one-token steps are ported"
        )
    pos = params["wpe"][idx : idx + t].float()
    x = (inputs_embeds.float() + pos[None]).to(policy.compute_dtype)
    k_all, v_all = cache["k"], cache["v"]
    blocks = params["blocks"]

    for i in range(cfg.n_layer):
        bp = _layer(blocks, i)
        h = nn.layer_norm(bp["ln_1"], x, cfg.layer_norm_epsilon)
        qkv = nn.dense(bp["attn"]["c_attn"], h, policy)
        q3, k3, v3 = torch.split(qkv, d, dim=-1)
        if t == 1:
            a_flat, _, _ = DA.decode_attention(
                q3[:, 0], k3[:, 0], v3[:, 0], k_all[i], v_all[i], idx, n_head=cfg.n_head,
                use_kernel=use_kernels,
            )
            a = a_flat[:, None, :].to(policy.compute_dtype)
        else:
            k_all[i, :t] = k3.transpose(0, 1).to(k_all.dtype)
            v_all[i, :t] = v3.transpose(0, 1).to(v_all.dtype)
            a = nn.merge_heads(mha(
                nn.split_heads(q3, cfg.n_head), nn.split_heads(k3, cfg.n_head),
                nn.split_heads(v3, cfg.n_head), causal=True, policy=policy,
                use_kernel=use_kernels,
            ))
        x = x + nn.dense(bp["attn"]["c_proj"], a, policy)
        h = nn.layer_norm(bp["ln_2"], x, cfg.layer_norm_epsilon)
        h = nn.gelu_new(nn.dense(bp["mlp"]["c_fc"], h, policy))
        x = x + nn.dense(bp["mlp"]["c_proj"], h, policy)

    x = nn.layer_norm(params["ln_f"], x[:, -1, :], cfg.layer_norm_epsilon)
    logits = nn.dot_f32(policy.cast(x), params["wte"].t().to(policy.compute_dtype))
    return logits, {"k": k_all, "v": v_all, "index": idx + t}


def _layer(blocks: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in blocks.items()}
