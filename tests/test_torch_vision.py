"""The port's vision towers (CLIP ViT-B/32, HF ViT, DINOv3 + dino.txt) against
the JAX package's on the same weights, carried across as numpy: float32 to
1e-4 from float pixels and from uint8 pixels (the port's ``encode_image_u8``
through the patch-embed twin, against JAX ``normalize_on_device`` +
``encode_image``), and bf16; the port maps against random-init HF models and,
at full scale, against the JAX package's maps on the fabricated CLIP and
DINOv3 checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from gpt2_image_captioning_tpu.core.precision import BF16 as JBF16
from gpt2_image_captioning_tpu.embeddings import preprocess as JP
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import dino as JDN
from gpt2_image_captioning_tpu.models import porting as jporting
from gpt2_image_captioning_tpu.models import vit as JVT
from gpt2_image_captioning_tpu_torch.core.precision import BF16
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths, tree_map
from gpt2_image_captioning_tpu_torch.embeddings import preprocess as TP
from gpt2_image_captioning_tpu_torch.models import clip as TCL
from gpt2_image_captioning_tpu_torch.models import dino as TDN
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.models import vit as TVT

from fabricate_assets import fabricate_clip_ckpt, fabricate_dinov3_ckpt

TOWERS = {  # name: (JAX module, JAX init, port module, port config, spec name)
    "clip": (JCL, JCL.init_vision, TCL, TCL.CLIPVisionConfig.tiny(), "clip"),
    "vit": (JVT, JVT.init, TVT, TVT.ViTConfig.tiny(), "vit"),
    "dino": (JDN, JDN.init, TDN, TDN.DINOv3Config.tiny(), "dino"),
}
JCFG = {"clip": JCL.CLIPVisionConfig.tiny(), "vit": JVT.ViTConfig.tiny(),
        "dino": JDN.DINOv3Config.tiny()}


def _spec(mod, name):
    import dataclasses

    s = mod.SPECS[name]
    return dataclasses.replace(s, resize=32, crop=None if s.crop is None else 32)


def _tower(name, seed=0):
    jmod, jinit, tmod, tcfg, _ = TOWERS[name]
    jparams = jinit(jax.random.PRNGKey(seed), JCFG[name])
    tparams = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmod, jparams, tmod, tparams, tcfg


@pytest.mark.parametrize("name", ["clip", "vit", "dino"])
def test_tower_matches_jax_float32(name):
    """``encode_image`` from float pixels, and ``encode_image_u8`` from uint8
    pixels against the JAX tower after its ``normalize_on_device``, to 1e-4;
    both unit vectors; the port's random init has the JAX tree's shapes."""
    jmod, jparams, tmod, tparams, cfg = _tower(name)
    rng = np.random.default_rng(1)
    px = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jmod.encode_image(jparams, JCFG[name], jnp.asarray(px)))
    got = tmod.encode_image(tparams, cfg, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)

    u8 = rng.integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    jspec, tspec = _spec(JP, TOWERS[name][4]), _spec(TP, TOWERS[name][4])
    want_u8 = np.asarray(jmod.encode_image(jparams, JCFG[name],
                                           JP.normalize_on_device(jnp.asarray(u8), jspec)))
    got_u8 = tmod.encode_image_u8(tparams, cfg, torch.from_numpy(u8), tspec)
    np.testing.assert_allclose(got_u8.numpy(), want_u8, atol=1e-4, rtol=1e-4)

    init = TOWERS[name][2].__dict__["init_vision" if name == "clip" else "init"]
    fresh = flatten_with_paths(init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    theirs = flatten_with_paths(jax.tree.map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in theirs.items()}


@pytest.mark.parametrize("name", ["clip", "vit", "dino"])
def test_tower_bf16_matches_jax_bf16(name):
    """bf16 policy on both sides, from uint8 pixels: the port rounds the
    normalised patches to bf16 inside the patch embedding, the JAX tower
    before its product; both round every layer's activations to bf16, so
    the unit-norm features differ by bf16 rounding compounded over 2 layers
    (2^-8 relative a step).  Measured: at most 2.8e-3 on components of up
    to 0.76 (CLIP 1.7e-3, ViT 2.8e-3, DINOv3 6e-8); held to 1e-2."""
    jmod, jparams, tmod, tparams, cfg = _tower(name, seed=2)
    u8 = np.random.default_rng(3).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    jspec, tspec = _spec(JP, TOWERS[name][4]), _spec(TP, TOWERS[name][4])
    want = np.asarray(jmod.encode_image(jparams, JCFG[name],
                                        JP.normalize_on_device(jnp.asarray(u8), jspec),
                                        policy=JBF16), np.float32)
    got = tmod.encode_image_u8(tparams, cfg, torch.from_numpy(u8), tspec, policy=BF16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2)


def test_rope_matches_jax():
    cfg = TDN.DINOv3Config.tiny()
    cos, sin = TDN.rope_angles(cfg, 3, 5)
    jcos, jsin = JDN.rope_angles(JCFG["dino"], 3, 5)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    x = np.random.default_rng(0).normal(size=(2, 4, 15, cfg.head_dim)).astype(np.float32)
    np.testing.assert_allclose(TDN.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
                               np.asarray(JDN.apply_rope(jnp.asarray(x), jcos, jsin)),
                               atol=1e-6)


def test_clip_and_vit_maps_match_hf():
    """``port_clip_vision`` / ``port_vit`` on random-init HF models: the port's
    towers give HF's features."""
    torch.manual_seed(0)
    ccfg = TCL.CLIPVisionConfig.tiny()
    hf = transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(
        hidden_size=ccfg.hidden_size, intermediate_size=ccfg.intermediate_size,
        num_hidden_layers=ccfg.num_hidden_layers, num_attention_heads=ccfg.num_attention_heads,
        image_size=ccfg.image_size, patch_size=ccfg.patch_size,
        projection_dim=ccfg.projection_dim, attention_dropout=0.0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        want = hf(pixel_values=x).image_embeds
    got = TCL.encode_image(porting.port_clip_vision(hf.state_dict(), ccfg), ccfg, x,
                           normalize=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)

    vcfg = TVT.ViTConfig.tiny()
    hf = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=vcfg.hidden_size, intermediate_size=vcfg.intermediate_size,
        num_hidden_layers=vcfg.num_hidden_layers, num_attention_heads=vcfg.num_attention_heads,
        image_size=vcfg.image_size, patch_size=vcfg.patch_size, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=vcfg.layer_norm_eps)).eval()
    with torch.no_grad():
        out = hf(pixel_values=x)
    hidden, pooled = TVT.forward(porting.port_vit(hf.state_dict(), vcfg), vcfg, x)
    np.testing.assert_allclose(hidden.numpy(), out.last_hidden_state.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(), atol=2e-5, rtol=2e-5)


def _same_tree(port_tree, jax_tree):
    ours = flatten_with_paths(tree_map(lambda t: t.numpy(), port_tree))
    theirs = flatten_with_paths(jax.tree.map(np.asarray, jax_tree))
    assert ours.keys() == theirs.keys()
    for key, value in ours.items():
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)


@pytest.mark.parametrize("which", ["clip", "dinov3"])
def test_port_maps_at_full_scale(which, tmp_path):
    """The maps on the fabricated full-size checkpoints (CLIP ViT-B/32 from a
    random-init HF ``CLIPModel``; DINOv3 ViT-L/16 with a dino.txt head, the
    torch-hub names) give the JAX package's trees exactly."""
    from safetensors.torch import load_file

    path = str(tmp_path / f"{which}.ckpt")
    if which == "clip":
        fabricate_clip_ckpt(path)
        sd = load_file(path)
        cfg = TCL.CLIPVisionConfig.vit_b32()
        _same_tree(porting.port_clip_vision(sd, cfg),
                   jporting.port_clip_vision(sd, JCL.CLIPVisionConfig.vit_b32()))
    else:
        fabricate_dinov3_ckpt(path)
        sd = torch.load(path, map_location="cpu")["model"]  # the hub file's wrapper
        cfg, jcfg = TDN.DINOv3Config.vitl16(), JDN.DINOv3Config.vitl16()
        got = porting.port_dinotxt_head(porting.port_dinov3_backbone(sd, cfg), sd, cfg)
        want = jporting.port_dinotxt_head(jporting.port_dinov3_backbone(sd, jcfg), sd, jcfg)
        _same_tree(got, want)
        with pytest.raises(KeyError, match="dino.txt vision head"):
            porting.port_dinotxt_head(got, {}, cfg)
