"""Embedding → prefix mapping networks — the counterpart of
``gpt2_image_captioning_tpu/models/mapping.py``, with the same parameter
layouts and numerics:

- :func:`mlp` — ``embed_dim → (prefix_len·gpt_dim)/2 → prefix_len·gpt_dim``
  with tanh, reshaped to ``(B, prefix_len, gpt_dim)``;
- :func:`transformer` — a linear map to ``hidden_length`` image tokens ⧺ a
  learned constant prefix, through a pre-norm Transformer encoder (ReLU FFN,
  bidirectional attention, no final norm), keeping the last
  ``prefix_length`` tokens.  Its attention goes through
  :func:`ops.attention.mha`: the flash kernel for CUDA tensors unless
  ``use_kernels=False``.  Every parameter, ``prefix_const`` and the linear map
  included, stays a leaf tensor, so gradients reach all of them.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha


@dataclasses.dataclass(frozen=True)
class MLPMappingConfig:
    prefix_length: int = 10
    embed_dim: int = 512
    gpt_dim: int = 768
    bias: bool = True

    type: str = dataclasses.field(default="mlp", init=False)


@dataclasses.dataclass(frozen=True)
class TransformerMappingConfig:
    embed_dim: int = 512
    gpt_dim: int = 768
    prefix_length: int = 15
    hidden_length: int = 10
    num_layers: int = 8
    num_heads: int = 8
    layer_norm_eps: float = 1e-5

    type: str = dataclasses.field(default="transformer", init=False)


MappingConfig = MLPMappingConfig | TransformerMappingConfig


def make_mapping_config(cfg_block) -> MappingConfig:
    """Build a mapping config from the ``mapping:`` block of config.yml."""
    kind = cfg_block["type"]
    if kind == "mlp":
        return MLPMappingConfig(
            prefix_length=cfg_block["prefix_length"],
            embed_dim=cfg_block["embed_dim"],
            gpt_dim=cfg_block["gpt_dim"],
        )
    if kind == "transformer":
        return TransformerMappingConfig(
            embed_dim=cfg_block["embed_dim"],
            gpt_dim=cfg_block["gpt_dim"],
            prefix_length=cfg_block["prefix_length"],
            hidden_length=cfg_block["hidden_length"],
        )
    raise ValueError(f"Unknown mapping type: {kind!r} (expected 'mlp' or 'transformer')")


# ---------------------------------------------------------------------------
# MLP mapper
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, cfg: MLPMappingConfig) -> dict:
    out_dim = cfg.prefix_length * cfg.gpt_dim
    hidden = out_dim // 2
    return {
        "fc1": nn.dense_init(generator, cfg.embed_dim, hidden, std=None, bias=cfg.bias),
        "fc2": nn.dense_init(generator, hidden, out_dim, std=None, bias=cfg.bias),
    }


def mlp(params: dict, cfg: MLPMappingConfig, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    """(B, embed_dim) → (B, prefix_length, gpt_dim)"""
    h = torch.tanh(nn.dense(params["fc1"], x, policy).float()).to(policy.compute_dtype)
    out = nn.dense(params["fc2"], h, policy)
    return out.reshape(x.shape[0], cfg.prefix_length, cfg.gpt_dim)


# ---------------------------------------------------------------------------
# Transformer mapper
# ---------------------------------------------------------------------------

def init_transformer(generator: torch.Generator, cfg: TransformerMappingConfig) -> dict:
    d = cfg.gpt_dim
    params: dict = {
        "linear": nn.dense_init(generator, cfg.embed_dim, cfg.hidden_length * d, std=None),
        # learned constant prefix, N(0, 1)
        "prefix_const": torch.randn((cfg.prefix_length, d), generator=generator),
        "layers": [],
    }
    bound = (6.0 / (d + 3 * d)) ** 0.5  # xavier-uniform of the (3d, d) in_proj
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": nn.layer_norm_init(d),
            "attn": {
                "in_proj": {"w": nn.uniform(generator, (d, 3 * d), bound), "b": torch.zeros(3 * d)},
                "out_proj": nn.dense_init(generator, d, d, std=None),
            },
            "ln2": nn.layer_norm_init(d),
            "fc1": nn.dense_init(generator, d, 4 * d, std=None),
            "fc2": nn.dense_init(generator, 4 * d, d, std=None),
        })
    return params


def _encoder_layer(lp: dict, cfg: TransformerMappingConfig, x: torch.Tensor,
                   policy: Policy, use_kernels: bool | None) -> torch.Tensor:
    """Pre-norm encoder layer: x += MHA(LN(x)); x += FFN(LN(x))."""
    h = nn.layer_norm(lp["ln1"], x, cfg.layer_norm_eps)
    qkv = nn.dense(lp["attn"]["in_proj"], h, policy)
    q, k, v = (nn.split_heads(t, cfg.num_heads) for t in torch.split(qkv, cfg.gpt_dim, dim=-1))
    a = mha(q, k, v, causal=False, policy=policy, use_kernel=use_kernels)
    x = x + nn.dense(lp["attn"]["out_proj"], nn.merge_heads(a), policy)
    h = nn.layer_norm(lp["ln2"], x, cfg.layer_norm_eps)
    h = torch.relu(nn.dense(lp["fc1"], h, policy))
    return x + nn.dense(lp["fc2"], h, policy)


def transformer(params: dict, cfg: TransformerMappingConfig, x: torch.Tensor,
                policy: Policy = F32, use_kernels: bool | None = None) -> torch.Tensor:
    """(B, embed_dim) → (B, prefix_length, gpt_dim)"""
    b = x.shape[0]
    img_tokens = nn.dense(params["linear"], x, policy).reshape(b, cfg.hidden_length, cfg.gpt_dim)
    prefix = params["prefix_const"].to(policy.compute_dtype).expand(
        b, cfg.prefix_length, cfg.gpt_dim
    )
    h = torch.cat([img_tokens, prefix], dim=1)
    for lp in params["layers"]:
        h = _encoder_layer(lp, cfg, h, policy, use_kernels)
    return h[:, cfg.hidden_length :, :]


# ---------------------------------------------------------------------------
# Unified entry points
# ---------------------------------------------------------------------------

def init_mapping(generator: torch.Generator, cfg: MappingConfig) -> dict:
    if isinstance(cfg, MLPMappingConfig):
        return init_mlp(generator, cfg)
    return init_transformer(generator, cfg)


def apply_mapping(params: dict, cfg: MappingConfig, x: torch.Tensor,
                  policy: Policy = F32, use_kernels: bool | None = None) -> torch.Tensor:
    if isinstance(cfg, MLPMappingConfig):
        return mlp(params, cfg, x, policy)
    return transformer(params, cfg, x, policy, use_kernels)
