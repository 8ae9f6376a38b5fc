"""HF ViT-base (``google/vit-base-patch16-224``) — the counterpart of
``gpt2_image_captioning_tpu/models/vit.py``, with the same parameter tree.

The patch convolution (with bias) as a product over unfolded patches, CLS
and learned positions, pre-norm layers (``layernorm_before`` / ``after``,
exact-erf GELU), the final LayerNorm and the tanh pooler, whose output is
the extractor's feature (768-d).  Attention goes through
:func:`ops.attention.mha` (the flash kernel on the card, T = 197 at 224 /
16).  :func:`encode_image_u8` takes uint8 pixels through
:func:`ops.patch_embed.patch_embed`, which carries the bias.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import PreprocessSpec
from gpt2_image_captioning_tpu_torch.models.clip import layer_params, on_device
from gpt2_image_captioning_tpu_torch.models.gpt2 import stack_blocks
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha
from gpt2_image_captioning_tpu_torch.ops.patch_embed import extract_patches, patch_embed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 16
    layer_norm_eps: float = 1e-12  # HF ViT default

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def base_patch16_224() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=4, image_size=32, patch_size=8)


def _init_layer(g: torch.Generator, d: int, inter: int) -> dict:
    return {
        "ln_before": nn.layer_norm_init(d),
        "attn": {name: nn.dense_init(g, d, d, std=None) for name in ("q", "k", "v", "out")},
        "ln_after": nn.layer_norm_init(d),
        "mlp": {"fc1": nn.dense_init(g, d, inter, std=None),
                "fc2": nn.dense_init(g, inter, d, std=None)},
    }


def init(generator: torch.Generator, cfg: ViTConfig, device=DEFAULT_DEVICE) -> dict:
    """Random ViT with the JAX package's distributions, float32 on ``device``."""
    d = cfg.hidden_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    params = {
        "cls_token": nn.normal(generator, (1, 1, d), 0.02),
        "patch_embedding": {"w": nn.normal(generator, (patch_dim, d), 0.02),
                            "b": torch.zeros(d)},
        "position_embeddings": nn.normal(generator, (1, cfg.num_patches + 1, d), 0.02),
        "layers": stack_blocks([_init_layer(generator, d, cfg.intermediate_size)
                                for _ in range(cfg.num_hidden_layers)]),
        "final_layernorm": nn.layer_norm_init(d),
        "pooler": nn.dense_init(generator, d, d, std=None),
    }
    return on_device(params, device)


def _layer(lp: dict, x: torch.Tensor, n_head: int, eps: float, policy: Policy,
           use_kernels: bool | None) -> torch.Tensor:
    h = nn.layer_norm(lp["ln_before"], x, eps)
    q, k, v = (nn.split_heads(nn.dense(lp["attn"][n], h, policy), n_head) for n in "qkv")
    a = mha(q, k, v, causal=False, policy=policy, use_kernel=use_kernels)
    x = x + nn.dense(lp["attn"]["out"], nn.merge_heads(a), policy)
    h = nn.layer_norm(lp["ln_after"], x, eps)
    h = nn.gelu_exact(nn.dense(lp["mlp"]["fc1"], h, policy))
    return x + nn.dense(lp["mlp"]["fc2"], h, policy)


def _tower(params: dict, cfg: ViTConfig, x: torch.Tensor, policy: Policy,
           use_kernels: bool | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Patch embeddings (B, N, D) in the compute dtype → (last hidden (B, N+1,
    D), pooler output (B, D))."""
    b = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = (x.float() + params["position_embeddings"].float()).to(policy.compute_dtype)
    for i in range(cfg.num_hidden_layers):
        x = _layer(layer_params(params["layers"], i), x, cfg.num_attention_heads,
                   cfg.layer_norm_eps, policy, use_kernels)
    x = nn.layer_norm(params["final_layernorm"], x, cfg.layer_norm_eps)
    pooled = torch.tanh(nn.dense(params["pooler"], x[:, 0], policy).float())
    return x, pooled.to(policy.compute_dtype)


def forward(params: dict, cfg: ViTConfig, pixel_values: torch.Tensor, policy: Policy = F32,
            use_kernels: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, H, W) → (last_hidden (B, N+1, D), pooler_output (B, D))."""
    patches = extract_patches(pixel_values.to(policy.compute_dtype), cfg.patch_size)
    return _tower(params, cfg, nn.dense(params["patch_embedding"], patches, policy), policy,
                  use_kernels)


def _normalize(pooled: torch.Tensor, normalize: bool) -> torch.Tensor:
    if normalize:
        pooled = pooled / torch.linalg.vector_norm(pooled.float(), dim=-1, keepdim=True)
    return pooled


def encode_image(params: dict, cfg: ViTConfig, pixel_values: torch.Tensor, policy: Policy = F32,
                 normalize: bool = True, use_kernels: bool | None = None) -> torch.Tensor:
    """pooler_output ([CLS]) features, L2-normalised as the extractor does →
    (B, hidden)."""
    return _normalize(forward(params, cfg, pixel_values, policy, use_kernels)[1], normalize)


def encode_image_u8(params: dict, cfg: ViTConfig, batch_u8: torch.Tensor, spec: PreprocessSpec,
                    policy: Policy = F32, normalize: bool = True,
                    use_kernels: bool | None = None) -> torch.Tensor:
    """:func:`encode_image` from host-preprocessed uint8 pixels (B, S, S, 3)."""
    pe = params["patch_embedding"]
    x = patch_embed(batch_u8, pe["w"], spec, cfg.patch_size, bias=pe["b"],
                    compute_dtype=policy.compute_dtype, use_kernel=use_kernels)
    return _normalize(_tower(params, cfg, x.to(policy.compute_dtype), policy, use_kernels)[1],
                      normalize)
