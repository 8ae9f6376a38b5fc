"""Per-encoder image preprocessing — the counterpart of
``gpt2_image_captioning_tpu/embeddings/preprocess.py``.

- CLIP: resize the shortest side to 224 bicubic, center-crop 224, scale
  1/255, normalise with CLIP's statistics.
- ViT: resize to exactly 224 x 224 bilinear, scale 1/255, normalise with
  mean = std = 0.5.
- DINOv3: resize the shortest side to 256 bicubic, center-crop 224,
  ImageNet statistics.

The geometric part (decode, resize, crop) runs on the host per image, with
PIL, which is imported only inside :func:`resize_and_crop` (the machine with
the card has no PIL; it is fed pixels that are already at size).  The
arithmetic part (scale, normalise, CHW) runs on the device: in
:func:`normalize_on_device`, or inside the patch-embed kernel
(:mod:`ops.patch_embed`) for the towers' uint8 entry points.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    resize: int            # target of the resize step
    crop: int | None       # center-crop size (None = resize is exact WxH)
    interpolation: str     # "bicubic" | "bilinear"
    mean: tuple[float, float, float]
    std: tuple[float, float, float]
    resize_shortest: bool = True  # shortest-side resize vs exact square

    @property
    def size(self) -> int:
        """Side of the square uint8 image the host step produces."""
        return self.crop if (self.resize_shortest and self.crop) else self.resize


CLIP_SPEC = PreprocessSpec(224, 224, "bicubic", CLIP_MEAN, CLIP_STD)
VIT_SPEC = PreprocessSpec(224, None, "bilinear", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5),
                          resize_shortest=False)
DINO_SPEC = PreprocessSpec(256, 224, "bicubic", IMAGENET_MEAN, IMAGENET_STD)

SPECS = {"clip": CLIP_SPEC, "vit": VIT_SPEC, "dino": DINO_SPEC}


def resize_and_crop(rgb: np.ndarray, spec: PreprocessSpec) -> np.ndarray:
    """uint8 (H, W, 3) → uint8 (S, S, 3), the host-side geometry (PIL)."""
    from PIL import Image

    resample = Image.BICUBIC if spec.interpolation == "bicubic" else Image.BILINEAR
    im = Image.fromarray(rgb)
    if spec.resize_shortest:
        w, h = im.size
        scale = spec.resize / min(w, h)
        im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))), resample)
        if spec.crop:
            w, h = im.size
            left = (w - spec.crop) // 2
            top = (h - spec.crop) // 2
            im = im.crop((left, top, left + spec.crop, top + spec.crop))
    else:
        im = im.resize((spec.resize, spec.resize), resample)
    return np.asarray(im, dtype=np.uint8)


def make_host_preprocess(spec: PreprocessSpec):
    """Per-image host function for ``ImageBatchLoader``: geometry only,
    uint8 HWC out."""
    return lambda rgb: resize_and_crop(rgb, spec)


def normalize_on_device(batch_u8: torch.Tensor, spec: PreprocessSpec) -> torch.Tensor:
    """uint8 (B, S, S, 3) → float32 (B, 3, S, S), scaled and normalised, on
    the batch's device."""
    x = batch_u8.float() / 255.0
    mean = torch.tensor(spec.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(spec.std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)
