"""DINOv3 ViT-L/16 backbone + the dino.txt vision head — the counterpart of
``gpt2_image_captioning_tpu/models/dino.py``, with the same parameter tree.

Backbone: 16 x 16 patches (unfold + product, with bias), a CLS token and
``num_register_tokens`` registers (no position embedding), axial RoPE on
the q/k of the patch tokens only (CLS and the registers keep raw q/k), and
pre-norm blocks with LayerScale on both residual branches and an exact-erf
GELU MLP.  The dino.txt head projects concat(CLS, mean of the patch tokens)
into the text-aligned space; the extractor L2-normalises.  Attention goes
through :func:`ops.attention.mha` (the flash kernel on the card, T = 201
at 224 / 16 with 4 registers); :func:`encode_image_u8` takes uint8 pixels
through :func:`ops.patch_embed.patch_embed`.
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
class DINOv3Config:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 16
    num_register_tokens: int = 4
    layer_norm_eps: float = 1e-6
    layerscale_init: float = 1e-5
    rope_base: float = 100.0
    # dino.txt head
    text_embed_dim: int = 2048

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def vitl16() -> "DINOv3Config":
        return DINOv3Config()

    @staticmethod
    def tiny() -> "DINOv3Config":
        return DINOv3Config(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, image_size=32, patch_size=8,
                            num_register_tokens=2, text_embed_dim=16)


def rope_angles(cfg: DINOv3Config, grid_h: int, grid_w: int, device=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, head_dim/2) cos/sin tables: the first half of the dims rotates with
    the normalised row coordinate, the second with the column."""
    d4 = cfg.head_dim // 4
    freqs = cfg.rope_base ** (-torch.arange(d4, dtype=torch.float32, device=device) / d4)
    ys = (torch.arange(grid_h, dtype=torch.float32, device=device) + 0.5) / grid_h * 2 - 1
    xs = (torch.arange(grid_w, dtype=torch.float32, device=device) + 0.5) / grid_w * 2 - 1
    ang_y = (ys[:, None] * freqs[None, :])[:, None, :].expand(grid_h, grid_w, d4)
    ang_x = (xs[:, None] * freqs[None, :])[None, :, :].expand(grid_h, grid_w, d4)
    ang = torch.cat([ang_y, ang_x], dim=-1).reshape(grid_h * grid_w, 2 * d4)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x1, x2) of each position.  x: (B, H, N, hd); cos/sin:
    (N, hd/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[None, None], sin[None, None]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _init_block(g: torch.Generator, cfg: DINOv3Config) -> dict:
    d, inter = cfg.hidden_size, cfg.intermediate_size
    return {
        "ln1": nn.layer_norm_init(d),
        "attn": {"qkv": nn.dense_init(g, d, 3 * d, std=None),
                 "proj": nn.dense_init(g, d, d, std=None)},
        "gamma1": torch.full((d,), cfg.layerscale_init),
        "ln2": nn.layer_norm_init(d),
        "mlp": {"fc1": nn.dense_init(g, d, inter, std=None),
                "fc2": nn.dense_init(g, inter, d, std=None)},
        "gamma2": torch.full((d,), cfg.layerscale_init),
    }


def init(generator: torch.Generator, cfg: DINOv3Config, device=DEFAULT_DEVICE) -> dict:
    """Random backbone and head with the JAX package's distributions, float32
    on ``device``."""
    d = cfg.hidden_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    params = {
        "patch_embedding": {"w": nn.normal(generator, (patch_dim, d), 0.02),
                            "b": torch.zeros(d)},
        "cls_token": nn.normal(generator, (1, 1, d), 0.02),
        "register_tokens": nn.normal(generator, (1, cfg.num_register_tokens, d), 0.02),
        "blocks": stack_blocks([_init_block(generator, cfg)
                                for _ in range(cfg.num_hidden_layers)]),
        "norm": nn.layer_norm_init(d),
        # dino.txt vision head: concat(CLS, mean patch) -> text space
        "head": {"w": nn.normal(generator, (2 * d, cfg.text_embed_dim), 0.02)},
    }
    return on_device(params, device)


def _block(bp: dict, cfg: DINOv3Config, x, cos, sin, n_special: int, policy: Policy,
           use_kernels: bool | None) -> torch.Tensor:
    cdt = policy.compute_dtype
    h = nn.layer_norm(bp["ln1"], x, cfg.layer_norm_eps)
    qkv = nn.dense(bp["attn"]["qkv"], h, policy)
    q, k, v = (nn.split_heads(t, cfg.num_attention_heads) for t in torch.chunk(qkv, 3, dim=-1))
    # RoPE on the patch tokens only; CLS and the registers untouched
    q = torch.cat([q[:, :, :n_special], apply_rope(q[:, :, n_special:], cos, sin).to(q.dtype)],
                  dim=2)
    k = torch.cat([k[:, :, :n_special], apply_rope(k[:, :, n_special:], cos, sin).to(k.dtype)],
                  dim=2)
    a = mha(q, k, v, causal=False, policy=policy, use_kernel=use_kernels)
    x = x + bp["gamma1"].float() * nn.dense(bp["attn"]["proj"], nn.merge_heads(a), policy).float()
    x = x.to(cdt)
    h = nn.layer_norm(bp["ln2"], x, cfg.layer_norm_eps)
    h = nn.gelu_exact(nn.dense(bp["mlp"]["fc1"], h, policy))
    x = x + bp["gamma2"].float() * nn.dense(bp["mlp"]["fc2"], h, policy).float()
    return x.to(cdt)


def _tower(params: dict, cfg: DINOv3Config, x: torch.Tensor, grid: tuple[int, int],
           policy: Policy, use_kernels: bool | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Patch embeddings (B, N, D) in the compute dtype → (CLS (B, D), patch
    tokens (B, N, D)), after the final norm."""
    b = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    regs = params["register_tokens"].to(x.dtype).expand(b, cfg.num_register_tokens,
                                                        cfg.hidden_size)
    x = torch.cat([cls, regs, x], dim=1)
    n_special = 1 + cfg.num_register_tokens
    cos, sin = rope_angles(cfg, *grid, device=x.device)
    for i in range(cfg.num_hidden_layers):
        x = _block(layer_params(params["blocks"], i), cfg, x, cos, sin, n_special, policy,
                   use_kernels)
    x = nn.layer_norm(params["norm"], x, cfg.layer_norm_eps)
    return x[:, 0], x[:, n_special:]


def forward(params: dict, cfg: DINOv3Config, pixel_values: torch.Tensor, policy: Policy = F32,
            use_kernels: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, H, W) → (cls (B, D), patch_tokens (B, N, D)), after the final
    norm."""
    _, _, h, w = pixel_values.shape
    patches = extract_patches(pixel_values.to(policy.compute_dtype), cfg.patch_size)
    x = nn.dense(params["patch_embedding"], patches, policy)
    grid = (h // cfg.patch_size, w // cfg.patch_size)
    return _tower(params, cfg, x, grid, policy, use_kernels)


def _head(params: dict, cls: torch.Tensor, patches: torch.Tensor, policy: Policy,
          normalize: bool) -> torch.Tensor:
    cdt = policy.compute_dtype
    pooled = torch.cat([cls, patches.mean(dim=1)], dim=-1)
    feats = nn.dot_f32(pooled.to(cdt), params["head"]["w"].to(cdt))
    if normalize:
        feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats


def encode_image(params: dict, cfg: DINOv3Config, pixel_values: torch.Tensor,
                 policy: Policy = F32, normalize: bool = True,
                 use_kernels: bool | None = None) -> torch.Tensor:
    """dino.txt ``encode_image``: concat(CLS, mean patch) → head, then the
    extractor's L2 norm → (B, text_embed_dim) float32."""
    return _head(params, *forward(params, cfg, pixel_values, policy, use_kernels), policy,
                 normalize)


def encode_image_u8(params: dict, cfg: DINOv3Config, batch_u8: torch.Tensor,
                    spec: PreprocessSpec, policy: Policy = F32, normalize: bool = True,
                    use_kernels: bool | None = None) -> torch.Tensor:
    """:func:`encode_image` from host-preprocessed uint8 pixels (B, S, S, 3)."""
    pe = params["patch_embedding"]
    x = patch_embed(batch_u8, pe["w"], spec, cfg.patch_size, bias=pe["b"],
                    compute_dtype=policy.compute_dtype, use_kernel=use_kernels)
    gs = batch_u8.shape[1] // cfg.patch_size
    cls, patches = _tower(params, cfg, x.to(policy.compute_dtype), (gs, gs), policy, use_kernels)
    return _head(params, cls, patches, policy, normalize)
