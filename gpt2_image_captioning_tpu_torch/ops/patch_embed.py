"""Patch embedding from uint8 pixels — the counterpart of
``gpt2_image_captioning_tpu/ops/patch_embed.py``.

Kernel: ``csrc/patch_embed.cu`` (hand-written CUDA for sm_90a; its header
gives the design and the bound), the port of the JAX package's Pallas
``_kernel``: the (B, S, S, 3) uint8 pixels are unfolded into patches inside
the tile load, in the pixels' own order (a patch row is 3·patch contiguous
bytes, read as 16-byte vectors where every such run is 16-byte aligned, a
byte at a time otherwise: the kernel's dispatch decides), scaled by 1/255,
normalised per element and cast to the operand type on their way into
shared memory, then multiplied by the (K, D) patch weights into (B·N, D)
float32 — no patch tensor reaches device memory.  Wrapped by :func:`patch_embed_cuda`.  Plain twin:
:func:`patch_embed_plain`, the XLA composition of the JAX package (unfold,
scale, normalise, one product), which the reference measured bit-identical
to its kernel.

Operands are in ``compute_dtype``: bf16 on the tensor cores (wgmma), as
the towers round their patches to the compute dtype before the product;
float32 on the tensor cores (wgmma TF32) as a three-term TF32 split, within
float32 summation order of the float32 product: each accumulator chain of
the split's products is at most :data:`PE_TF32_CHAIN` k8 steps long, then
added into a float32 running tile.  :func:`patch_layout` mirrors each
route's tile, ring and shared memory.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from gpt2_image_captioning_tpu_torch.embeddings.preprocess import PreprocessSpec
from gpt2_image_captioning_tpu_torch.ops import _build, nn


# k8 steps of TF32 products (three wgmma instructions each) that the float32
# route folds into one fresh accumulator before adding it into the float32
# running tile; csrc/patch_embed.cu mirrors it (PE_TF32_CHAIN).  The tensor
# core's float32 accumulation drifts one way on the card, so a chain over the
# whole of CLIP's K 3,072 (384 steps) would take, in the CPU emulation
# (tests/test_torch_patch_tf32.py), about two thirds of PATCH_TOL; 12 steps
# (a pixel group's three channels) take a fiftieth.
PE_TF32_CHAIN = 12


class PatchLayout(NamedTuple):
    rows: int        # output rows (patches) of a block: two consumer warpgroups of 64
    cols: int        # output columns of a block: the wgmma N
    k_stage: int     # K of a ring stage
    stages: int      # ring stages
    threads: int     # two consumer warpgroups and one producer (service) warpgroup
    chain: int       # k8 steps of an accumulator chain (0: the whole of K)
    smem_bytes: int  # dynamic shared memory


@functools.cache
def patch_layout(dtype: torch.dtype) -> PatchLayout:
    """Mirror of ``csrc/patch_embed.cu``'s two routes (its
    ``gic_patch_layout``).  bf16: 128 x 256 tiles, stages of 48 K (16 pixels
    of 3 channels) in a ring of 4, each slot an A tile of 128-byte rows, W's
    48 x 256 bf16 and the stage's mean / inv_std, padded to 1 KB.  float32:
    128 patches x 128 columns, stages of 32 K (32 pixels of one channel) in
    a ring of 4, each slot the pixels' TF32 pair (128 rows of 128 bytes each)
    and W's four 32 x 32 boxes as landed.  384 threads in both."""
    if dtype == torch.float32:
        stage = 2 * 128 * 128 + 4 * 32 * 32 * 4
        return PatchLayout(128, 128, 32, 4, 384, PE_TF32_CHAIN, 1024 + 4 * stage)
    stage = -(-(128 * 128 + 48 * 256 * 2 + 2 * 48 * 4) // 1024) * 1024
    return PatchLayout(128, 256, 48, 4, 384, 0, 1024 + 4 * stage)


def extract_patches(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) → (B, N, C·patch·patch) with torch-conv channel order, so
    a stride-``patch`` convolution becomes one product."""
    b, c, h, w = pixel_values.shape
    hp, wp = h // patch, w // patch
    x = pixel_values.reshape(b, c, hp, patch, wp, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, hp * wp, c * patch * patch)


def normalization_vectors(spec: PreprocessSpec, patch: int, device=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-element (K = 3·p²) mean and inverse std in the (c, py, px) order
    of :func:`extract_patches`."""
    return _vectors(tuple(spec.mean), tuple(spec.std), patch, str(torch.device(device or "cpu")))


@functools.cache
def _vectors(mean, std, patch: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    m = torch.tensor(mean, dtype=torch.float32).repeat_interleave(patch * patch)
    s = torch.tensor(std, dtype=torch.float32).repeat_interleave(patch * patch)
    return m.to(device), (1.0 / s).to(device)


def _unfold_u8(batch_u8: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, S, S, 3) uint8 → (B·N, 3·patch²) uint8 patches."""
    return extract_patches(batch_u8.permute(0, 3, 1, 2), patch).reshape(-1, 3 * patch * patch)


def patch_embed_plain(batch_u8, w, mean_vec, inv_vec, patch: int, bias=None) -> torch.Tensor:
    """Plain twin of ``csrc/patch_embed.cu``; arguments as
    :func:`patch_embed_cuda`."""
    x = _unfold_u8(batch_u8, patch).float() * (1.0 / 255.0)
    x = ((x - mean_vec[None]) * inv_vec[None]).to(w.dtype)
    out = nn.dot_f32(x, w)
    if bias is not None:
        out = out + bias.float()
    return out


def patch_embed_cuda(batch_u8, w, mean_vec, inv_vec, patch: int, bias=None) -> torch.Tensor:
    """Launch ``csrc/patch_embed.cu``.  batch_u8: (B, S, S, 3) uint8,
    contiguous, S a multiple of ``patch`` (any such patch: the alignment of
    its rows decides only how the kernel reads them); w:
    (3·patch², D) contiguous in the operand type (bf16 or float32);
    mean_vec / inv_vec: (3·patch²,) float32 (:func:`normalization_vectors`);
    bias: (D,) float32 or None.
    Returns (B·N, D) float32, N = (S / patch)²."""
    name = "patch_embed"
    _build.require(batch_u8.is_cuda, name, "pixels must be a CUDA tensor")
    _build.require(batch_u8.dtype == torch.uint8 and batch_u8.dim() == 4
                   and batch_u8.shape[3] == 3 and batch_u8.shape[1] == batch_u8.shape[2]
                   and batch_u8.is_contiguous(), name,
                   "pixels must be contiguous uint8 (B, S, S, 3)")
    b, s = batch_u8.shape[:2]
    _build.require(s % patch == 0, name, f"image side {s} is not a multiple of patch {patch}")
    k = 3 * patch * patch
    _build.require(w.dtype in _build.DTYPE_CODE, name, f"unsupported operand dtype {w.dtype}")
    _build.require(w.dim() == 2 and w.shape[0] == k and w.is_contiguous()
                   and w.data_ptr() % 16 == 0, name,
                   f"w must be contiguous, 16-byte aligned ({k}, D)")
    d = w.shape[1]
    _build.require(d % (16 // w.element_size()) == 0, name,
                   "D must be a multiple of 8 (bf16) or 4 (float32)")
    for t in (mean_vec, inv_vec):
        _build.require(t.shape == (k,) and t.dtype == torch.float32 and t.is_contiguous(), name,
                       f"mean and inv_std must be contiguous float32 ({k},)")
    if bias is not None:
        _build.require(bias.shape == (d,) and bias.dtype == torch.float32
                       and bias.is_contiguous() and bias.data_ptr() % 16 == 0, name,
                       "bias must be contiguous, 16-byte aligned float32 (D,)")
    for t in (w, mean_vec, inv_vec) + (() if bias is None else (bias,)):
        _build.require(t.device == batch_u8.device, name, "all tensors must be on one device")
    out = torch.empty((b * (s // patch) ** 2, d), dtype=torch.float32, device=batch_u8.device)
    err = _build.library().gic_patch_embed(
        _build.DTYPE_CODE[w.dtype], batch_u8.data_ptr(), w.data_ptr(), mean_vec.data_ptr(),
        inv_vec.data_ptr(), _build.ptr(bias), out.data_ptr(), b, s, patch, d,
        _build.stream_of(batch_u8),
    )
    _build.check(err, name)
    patch_embed_cuda.launches += 1
    return out


patch_embed_cuda.launches = 0


def patch_embed(batch_u8: torch.Tensor, w: torch.Tensor, spec: PreprocessSpec, patch: int,
                bias: torch.Tensor | None = None, *, compute_dtype: torch.dtype = torch.float32,
                use_kernel: bool | None = None) -> torch.Tensor:
    """(B, S, S, 3) uint8 host-preprocessed pixels → (B, N, D) float32 patch
    embeddings: :func:`preprocess.normalize_on_device` +
    :func:`extract_patches` + the product with ``w`` (3·p², D) in
    ``compute_dtype`` (+ ``bias``).  The kernel for CUDA pixels, the twin for
    CPU pixels or ``use_kernel=False``."""
    b, s = batch_u8.shape[:2]
    mean_vec, inv_vec = normalization_vectors(spec, patch, batch_u8.device)
    wc = w.to(compute_dtype).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    if _build.kernels_enabled(use_kernel, batch_u8.device):
        out = patch_embed_cuda(batch_u8.contiguous(), wc, mean_vec, inv_vec, patch, bias)
    else:
        out = patch_embed_plain(batch_u8, wc, mean_vec, inv_vec, patch, bias)
    return out.reshape(b, (s // patch) ** 2, -1)
