"""CLIP ViT-B/32's two towers — the counterpart of
``gpt2_image_captioning_tpu/models/clip.py``: ``get_image_features`` and
``get_text_features`` of HF's ``CLIPModel`` plus the extractors' L2
normalisation, with the same parameter trees.

The patch convolution is a product over unfolded patches; then CLS and
learned positions, pre-LN, N pre-norm layers (quick-GELU MLP), post-LN on
CLS and the projection.  Attention goes through :func:`ops.attention.mha`:
the flash kernel for CUDA tensors (non-causal, T = 50 at 224 / 32).

Two entry points: :func:`encode_image` takes normalised float pixels (B, 3,
H, W), as the JAX function does; :func:`encode_image_u8` takes the host's
uint8 (B, S, S, 3) pixels and embeds the patches with
:func:`ops.patch_embed.patch_embed` (the patch-embed kernel on the card),
in place of normalising, unfolding and multiplying in three steps.

The text tower (:func:`encode_text`, the caption embeddings of retrieval):
token and position embeddings, the same layers with causal attention (the
flash kernel at T 77, hd 64 on the card), the final LN, the features at
each row's first EOT (``argmax`` of ``ids == eos_token_id``, as HF pools),
the text projection.
"""

from __future__ import annotations

import dataclasses

import torch

from gpt2_image_captioning_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from gpt2_image_captioning_tpu_torch.core.precision import F32, Policy
from gpt2_image_captioning_tpu_torch.core.tree import tree_map
from gpt2_image_captioning_tpu_torch.embeddings.preprocess import PreprocessSpec
from gpt2_image_captioning_tpu_torch.models.gpt2 import stack_blocks
from gpt2_image_captioning_tpu_torch.ops import nn
from gpt2_image_captioning_tpu_torch.ops.attention import mha
from gpt2_image_captioning_tpu_torch.ops.patch_embed import extract_patches, patch_embed


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def vit_b32() -> "CLIPVisionConfig":
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=32, patch_size=8, projection_dim=16,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407  # openai/clip-vit-base-patch32's EOT id

    @staticmethod
    def tiny(vocab_size: int = 99) -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16,
            projection_dim=16, eos_token_id=vocab_size - 1,
        )


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked on a leading layer dim."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def on_device(params: dict, device=DEFAULT_DEVICE) -> dict:
    """A tower's parameter tree on ``device`` (the card unless the caller asks
    for the CPU)."""
    device = resolve_device(device)
    return tree_map(lambda t: t.to(device), params)


def _init_clip_layer(g: torch.Generator, d: int, inter: int) -> dict:
    return {
        "ln1": nn.layer_norm_init(d),
        "attn": {name: nn.dense_init(g, d, d, std=None) for name in ("q", "k", "v", "out")},
        "ln2": nn.layer_norm_init(d),
        "mlp": {"fc1": nn.dense_init(g, d, inter, std=None),
                "fc2": nn.dense_init(g, inter, d, std=None)},
    }


def _clip_layer(lp: dict, x: torch.Tensor, n_head: int, eps: float, policy: Policy,
                use_kernels: bool | None, causal: bool = False) -> torch.Tensor:
    h = nn.layer_norm(lp["ln1"], x, eps)
    q, k, v = (nn.split_heads(nn.dense(lp["attn"][n], h, policy), n_head) for n in "qkv")
    a = mha(q, k, v, causal=causal, policy=policy, use_kernel=use_kernels)
    x = x + nn.dense(lp["attn"]["out"], nn.merge_heads(a), policy)
    h = nn.layer_norm(lp["ln2"], x, eps)
    h = nn.quick_gelu(nn.dense(lp["mlp"]["fc1"], h, policy))
    return x + nn.dense(lp["mlp"]["fc2"], h, policy)


def init_vision(generator: torch.Generator, cfg: CLIPVisionConfig, device=DEFAULT_DEVICE) -> dict:
    """Random vision tower with the JAX package's distributions (the draws
    differ from ``jax.random``'s), float32 on ``device``."""
    d = cfg.hidden_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    params = {
        "class_embedding": nn.normal(generator, (d,), 0.02),
        # matmul layout (patch_dim, d); no bias (CLIP's conv has none)
        "patch_embedding": nn.normal(generator, (patch_dim, d), 0.02),
        "position_embedding": nn.normal(generator, (cfg.num_patches + 1, d), 0.02),
        "pre_layernorm": nn.layer_norm_init(d),
        "layers": stack_blocks([_init_clip_layer(generator, d, cfg.intermediate_size)
                                for _ in range(cfg.num_hidden_layers)]),
        "post_layernorm": nn.layer_norm_init(d),
        "visual_projection": {"w": nn.normal(generator, (d, cfg.projection_dim), 0.02)},
    }
    return on_device(params, device)


def _tower(params: dict, cfg: CLIPVisionConfig, x: torch.Tensor, policy: Policy,
           use_kernels: bool | None) -> torch.Tensor:
    """Patch embeddings (B, N, D) float32 → pooled CLS features (B, D)."""
    b = x.shape[0]
    cls = params["class_embedding"].float().expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["position_embedding"].float()[None]
    x = nn.layer_norm(params["pre_layernorm"], x.to(policy.compute_dtype), cfg.layer_norm_eps)
    for i in range(cfg.num_hidden_layers):
        x = _clip_layer(layer_params(params["layers"], i), x, cfg.num_attention_heads,
                        cfg.layer_norm_eps, policy, use_kernels)
    return nn.layer_norm(params["post_layernorm"], x[:, 0], cfg.layer_norm_eps)


def vision_features(params: dict, cfg: CLIPVisionConfig, pixel_values: torch.Tensor,
                    policy: Policy = F32, use_kernels: bool | None = None) -> torch.Tensor:
    """pixel_values (B, 3, H, W) → pooled CLS features (B, hidden), before the
    projection."""
    cdt = policy.compute_dtype
    patches = extract_patches(pixel_values.to(cdt), cfg.patch_size)
    x = nn.dot_f32(patches, params["patch_embedding"].to(cdt))
    return _tower(params, cfg, x, policy, use_kernels)


def _project(params: dict, pooled: torch.Tensor, policy: Policy, normalize: bool):
    cdt = policy.compute_dtype
    feats = nn.dot_f32(pooled.to(cdt), params["visual_projection"]["w"].to(cdt))
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats


def encode_image(params: dict, cfg: CLIPVisionConfig, pixel_values: torch.Tensor,
                 policy: Policy = F32, normalize: bool = True,
                 use_kernels: bool | None = None) -> torch.Tensor:
    """``CLIPModel.get_image_features`` + the extractor's L2 normalisation →
    (B, projection_dim) float32."""
    pooled = vision_features(params, cfg, pixel_values, policy, use_kernels)
    return _project(params, pooled, policy, normalize)


def encode_image_u8(params: dict, cfg: CLIPVisionConfig, batch_u8: torch.Tensor,
                    spec: PreprocessSpec, policy: Policy = F32, normalize: bool = True,
                    use_kernels: bool | None = None) -> torch.Tensor:
    """:func:`encode_image` from host-preprocessed uint8 pixels (B, S, S, 3),
    normalised by ``spec`` inside :func:`ops.patch_embed.patch_embed`."""
    x = patch_embed(batch_u8, params["patch_embedding"], spec, cfg.patch_size,
                    compute_dtype=policy.compute_dtype, use_kernel=use_kernels)
    pooled = _tower(params, cfg, x, policy, use_kernels)
    return _project(params, pooled, policy, normalize)


# ---------------------------------------------------------------------------
# Text tower (the caption embeddings of retrieval)
# ---------------------------------------------------------------------------

def init_text(generator: torch.Generator, cfg: CLIPTextConfig, device=DEFAULT_DEVICE) -> dict:
    """Random text tower with the JAX package's distributions (the draws
    differ from ``jax.random``'s), float32 on ``device``."""
    d = cfg.hidden_size
    params = {
        "token_embedding": nn.normal(generator, (cfg.vocab_size, d), 0.02),
        "position_embedding": nn.normal(generator, (cfg.max_position_embeddings, d), 0.02),
        "layers": stack_blocks([_init_clip_layer(generator, d, cfg.intermediate_size)
                                for _ in range(cfg.num_hidden_layers)]),
        "final_layernorm": nn.layer_norm_init(d),
        "text_projection": {"w": nn.normal(generator, (d, cfg.projection_dim), 0.02)},
    }
    return on_device(params, device)


def encode_text(params: dict, cfg: CLIPTextConfig, input_ids: torch.Tensor,
                policy: Policy = F32, normalize: bool = True,
                use_kernels: bool | None = None) -> torch.Tensor:
    """``CLIPModel.get_text_features`` (+ L2 normalisation): token ids (B, T)
    → (B, projection_dim) float32, pooled at each row's first EOT."""
    input_ids = input_ids.long()
    b, t = input_ids.shape
    x = params["token_embedding"][input_ids].float()
    x = (x + params["position_embedding"][:t].float()[None]).to(policy.compute_dtype)
    for i in range(cfg.num_hidden_layers):
        x = _clip_layer(layer_params(params["layers"], i), x, cfg.num_attention_heads,
                        cfg.layer_norm_eps, policy, use_kernels, causal=True)
    x = nn.layer_norm(params["final_layernorm"], x, cfg.layer_norm_eps)
    eot = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
    pooled = x[torch.arange(b, device=x.device), eot]
    cdt = policy.compute_dtype
    feats = nn.dot_f32(pooled.to(cdt), params["text_projection"]["w"].to(cdt))
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats
