"""The port's uint8 patch embedding (``ops/patch_embed.py``: the plain twin
of ``csrc/patch_embed.cu``) and host preprocessing
(``embeddings/preprocess.py``) against the JAX package's: its Pallas
``patch_embed`` in interpret mode and its XLA composition, in float32 at the
JAX test's 1e-4, over the CLIP and ViT specs, patch sizes 8 and 16, with and
without a bias."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.embeddings import preprocess as JP
from gpt2_image_captioning_tpu.models.clip import extract_patches as jax_extract_patches
from gpt2_image_captioning_tpu.ops import patch_embed as JPE
from gpt2_image_captioning_tpu_torch.embeddings import preprocess as TP
from gpt2_image_captioning_tpu_torch.ops import patch_embed as TPE


def _specs(name, size):
    j, t = JP.SPECS[name], TP.SPECS[name]
    if name == "vit":
        return dataclasses.replace(j, resize=size), dataclasses.replace(t, resize=size)
    return (dataclasses.replace(j, resize=size, crop=size),
            dataclasses.replace(t, resize=size, crop=size))


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("patch", [8, 16])
@pytest.mark.parametrize("name", ["clip", "vit"])
def test_patch_embed_matches_jax_pallas_interpret(name, patch, bias):
    jspec, tspec = _specs(name, 32)
    rng = np.random.default_rng(patch + 3 * bias)
    batch = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    k, d = 3 * patch * patch, 48
    w = (rng.normal(size=(k, d)) * 0.02).astype(np.float32)
    b = rng.normal(size=(d,)).astype(np.float32) if bias else None
    want = JPE.patch_embed(jnp.asarray(batch), jnp.asarray(w), jspec, patch,
                           bias=None if b is None else jnp.asarray(b), use_pallas=True,
                           interpret=True)
    got = TPE.patch_embed(torch.from_numpy(batch), torch.from_numpy(w), tspec, patch,
                          bias=None if b is None else torch.from_numpy(b))
    assert got.shape == (2, (32 // patch) ** 2, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_patch_embed_equals_normalize_unfold_matmul():
    """The fused op reproduces ``normalize_on_device`` + ``extract_patches`` +
    the product, the towers' float-pixel path, on both packages."""
    jspec, tspec = _specs("vit", 16)
    rng = np.random.default_rng(5)
    batch = rng.integers(0, 256, size=(3, 16, 16, 3), dtype=np.uint8)
    w = rng.normal(size=(3 * 64, 32)).astype(np.float32)
    px = TP.normalize_on_device(torch.from_numpy(batch), tspec)
    np.testing.assert_allclose(
        px.numpy(), np.asarray(JP.normalize_on_device(jnp.asarray(batch), jspec)), atol=1e-6)
    patches = TPE.extract_patches(px, 8)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jax_extract_patches(
        JP.normalize_on_device(jnp.asarray(batch), jspec), 8)))
    ref = patches @ torch.from_numpy(w)
    got = TPE.patch_embed(torch.from_numpy(batch), torch.from_numpy(w), tspec, 8)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    mean, inv = TPE.normalization_vectors(tspec, 8)
    jmean, jinv = JPE.normalization_vectors(jspec, 8)
    np.testing.assert_array_equal(mean.numpy(), np.asarray(jmean))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-7)


def test_patch_embed_bf16_operands():
    """bf16 operands (the towers' bf16 policy): the normalised patches and
    the weights rounded to bf16, products summed in float32 — within a bf16
    rounding of each operand (2^-8 relative) of the float32 result, summed
    over K = 192 terms: measured 1.4e-2 at outputs of |max| 5.3, held to 5e-2;
    and within float32 summation order (1e-4) of the exact product of the
    rounded operands."""
    _, tspec = _specs("clip", 32)
    rng = np.random.default_rng(7)
    batch = torch.from_numpy(rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8))
    w = torch.from_numpy((rng.normal(size=(192, 40)) * 0.1).astype(np.float32))
    want = TPE.patch_embed(batch, w, tspec, 8)
    got = TPE.patch_embed(batch, w, tspec, 8, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-2)
    mean, inv = TPE.normalization_vectors(tspec, 8)
    x = ((TPE._unfold_u8(batch, 8).float() / 255.0 - mean) * inv).to(torch.bfloat16)
    exact = x.double() @ w.to(torch.bfloat16).double()
    np.testing.assert_allclose(got.reshape(-1, 40).numpy(), exact.numpy(), atol=1e-4, rtol=1e-4)


def test_patch_embed_kernel_refuses_cpu_pixels():
    _, tspec = _specs("clip", 32)
    batch = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    mean, inv = TPE.normalization_vectors(tspec, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TPE.patch_embed_cuda(batch, torch.zeros(192, 8), mean, inv, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TPE.patch_embed(batch, torch.zeros(192, 8), tspec, 8, use_kernel=True)


@pytest.mark.parametrize("name", ["clip", "vit", "dino"])
def test_host_preprocess_matches_jax(name):
    """PIL geometry (resize, crop) equals the JAX package's, pixel for pixel,
    on a landscape and a portrait image; the specs are the same."""
    assert dataclasses.asdict(TP.SPECS[name]) == dataclasses.asdict(JP.SPECS[name])
    rng = np.random.default_rng(11)
    for shape in ((300, 410, 3), (257, 230, 3)):
        rgb = rng.integers(0, 256, size=shape, dtype=np.uint8)
        got = TP.make_host_preprocess(TP.SPECS[name])(rgb)
        np.testing.assert_array_equal(got, JP.resize_and_crop(rgb, JP.SPECS[name]))
        assert got.shape == (TP.SPECS[name].size,) * 2 + (3,)


@pytest.mark.parametrize("side, patch, images, d", [(32, 8, 3, 40), (224, 14, 1, 24),
                                                    (64, 16, 3, 200)])
def test_patch_embed_matches_jax_at_the_kernels_edge_shapes(side, patch, images, d):
    """The byte-load route's patches (24- and 42-byte rows) and M and D off
    the kernel's tiles (48 rows by 200 columns; 128 and 256 are its tiles):
    the twin against the JAX package's Pallas kernel in interpret mode and
    its XLA composition, 1e-4 as the JAX test."""
    jspec, tspec = _specs("clip", side)
    rng = np.random.default_rng(side * patch)
    batch = rng.integers(0, 256, size=(images, side, side, 3), dtype=np.uint8)
    w = (rng.normal(size=(3 * patch * patch, d)) * 0.02).astype(np.float32)
    got = TPE.patch_embed(torch.from_numpy(batch), torch.from_numpy(w), tspec, patch)
    for use_pallas in (True, False):
        want = JPE.patch_embed(jnp.asarray(batch), jnp.asarray(w), jspec, patch,
                               use_pallas=use_pallas, interpret=use_pallas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
