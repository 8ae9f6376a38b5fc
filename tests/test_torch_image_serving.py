"""Images to captions with the port against the JAX package, in float32 at a
tiny config on the same weights: ``CaptionService`` (prepped batches,
arrays of any size, bytes, paths, a directory), the continuous service's
image intake (``submit_prepped``, ``submit_array``, ``caption_arrays``,
mixed with embeddings), embedding extraction over a directory of PNGs with
all three towers, the interchange ``.pt`` files, and the host loaders."""

import dataclasses
import io

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.data import embeddings_io as jio
from gpt2_image_captioning_tpu.data import images as jimages
from gpt2_image_captioning_tpu.embeddings import extract as jextract
from gpt2_image_captioning_tpu.embeddings import preprocess as JP
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import dino as JDN
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.models import vit as JVT
from gpt2_image_captioning_tpu.serving import CaptionService as JCaptionService
from gpt2_image_captioning_tpu.serving import ContinuousCaptionService as JContinuous
from gpt2_image_captioning_tpu_torch.core.mesh import Mesh, create_mesh
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.data import embeddings_io as tio
from gpt2_image_captioning_tpu_torch.data import images as timages
from gpt2_image_captioning_tpu_torch.data import native_pipe as tnative
from gpt2_image_captioning_tpu_torch.data import tokenizer as TT
from gpt2_image_captioning_tpu_torch.embeddings import extract as textract
from gpt2_image_captioning_tpu_torch.embeddings import preprocess as TP
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import clip as TCL
from gpt2_image_captioning_tpu_torch.models import dino as TDN
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.models import vit as TVT
from gpt2_image_captioning_tpu_torch.serving import CaptionService, ContinuousCaptionService

from helpers import tiny_tokenizer

# a mesh with a tensor-parallel axis, which the port refuses
TP2 = Mesh(dp=1, tp=2, rank=0, world_size=1, group=None, backend=None,
           device=torch.device("cpu"))


@pytest.fixture(scope="module")
def models():
    """The tiny CLIP tower and a tiny captioner fed by it, in both packages."""
    tok = tiny_tokenizer()
    n = len(tok.encoder)
    vcfg, tvcfg = JCL.CLIPVisionConfig.tiny(), TCL.CLIPVisionConfig.tiny()
    jv = JCL.init_vision(jax.random.PRNGKey(0), vcfg)
    tv = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, jv), device="cpu")
    gkw = dict(vocab_size=n, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=vcfg.projection_dim, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=tok, rng=jax.random.PRNGKey(4))
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    tmodel = TC.ImageCaptioningModel(tcfg, tokenizer=TT.GPT2BPETokenizer(dict(tok.encoder), merges),
                                     device="cpu")
    tmodel.trainable, tmodel.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (jmodel.trainable, jmodel.frozen)), tcfg, device="cpu")
    return jmodel, tmodel, jv, tv, vcfg, tvcfg


def _imgs(n, seed=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(40 + 7 * i, 52 - 3 * i, 3), dtype=np.uint8)
            for i in range(n)]


def _services(models, **kw):
    jmodel, tmodel, jv, tv, vcfg, tvcfg = models
    kw = dict(encoder="clip", batch_size=4, max_length=6, **kw)
    return (JCaptionService(jmodel, jv, vcfg, policy=JF32, **kw),
            CaptionService(tmodel, tv, tvcfg, policy=F32, **kw))


def test_caption_service_matches_jax(models, tmp_path):
    """Prepped batches (6 images: a full device batch and a padded one) and
    arrays of any size give the JAX service's captions; bytes, paths and a
    directory give the arrays' captions."""
    jsvc, svc = _services(models)
    assert svc.spec == dataclasses.replace(TP.CLIP_SPEC, resize=32, crop=32)
    assert dataclasses.asdict(svc.spec) == dataclasses.asdict(jsvc.spec)
    imgs = _imgs(6)
    prepped = np.stack([TP.resize_and_crop(im, svc.spec) for im in imgs])
    want = jsvc.caption_prepped(prepped)
    assert svc.caption_prepped(prepped) == want
    assert svc.caption_arrays(imgs) == jsvc.caption_arrays(imgs) == want
    stats = svc.stats
    assert stats["images"] == 12 and stats["requests"] == 2 and stats["img_per_s"] > 0

    blobs = []
    for i, im in enumerate(imgs):
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="PNG")
        blobs.append(buf.getvalue())
        (tmp_path / f"img_{i}.png").write_bytes(buf.getvalue())
    assert svc.caption_bytes(blobs) == want
    paths = [str(tmp_path / f"img_{i}.png") for i in range(6)]
    assert svc.caption_paths(paths) == want
    assert svc.caption_dir(str(tmp_path), num_workers=2) == {
        f"img_{i}.png": c for i, c in enumerate(want)}
    assert svc.caption_arrays([]) == []


def test_caption_service_sampling_and_refusals(models):
    """Sampled serving: a fresh generator per device batch from the service's
    seed, so two services with one seed agree and the counter advances;
    meshes and unknown encoders refuse."""
    tmodel, tv, tvcfg = models[1], models[3], models[5]
    svc_a, svc_b = (CaptionService(tmodel, tv, tvcfg, batch_size=4, max_length=6,
                                   temperature=0.9, top_p=0.9, policy=F32, seed=7)
                    for _ in range(2))
    imgs = _imgs(5, seed=9)
    assert svc_a.caption_arrays(imgs) == svc_b.caption_arrays(imgs)
    assert svc_a._draws == 2
    with pytest.raises(NotImplementedError, match="queue 1: tensor parallelism"):
        CaptionService(tmodel, tv, tvcfg, mesh=TP2)
    # a one-rank mesh serves as no mesh does, greedy and sampled
    for t in (0.0, 0.9):
        svcs = [CaptionService(tmodel, tv, tvcfg, batch_size=4, max_length=6, temperature=t,
                               policy=F32, seed=7, mesh=m)
                for m in (None, create_mesh(device="cpu"))]
        assert svcs[1].caption_arrays(imgs) == svcs[0].caption_arrays(imgs)
    with pytest.raises(ValueError, match="unknown encoder"):
        CaptionService(tmodel, tv, tvcfg, encoder="resnet")


def test_continuous_image_intake_matches_jax(models):
    """The continuous service fed prepped images, arrays and embeddings in one
    queue gives the JAX service's captions, which are the fixed-batch
    service's; the macros' staged images are encoded once."""
    jmodel, tmodel, jv, tv, vcfg, tvcfg = models
    kw = dict(slots=3, segment=2, bursts=2, admit=2, max_length=6)
    imgs = _imgs(7, seed=3)
    svc = ContinuousCaptionService(tmodel, tv, tvcfg, **kw)
    prepped = [TP.resize_and_crop(im, svc.spec) for im in imgs]
    emb = np.random.default_rng(2).normal(size=(vcfg.projection_dim,)).astype(np.float32)
    with pytest.raises(ValueError, match="prepped image must be"):
        svc.submit_prepped(np.zeros((8, 8, 3), np.uint8))
    calls = []
    encode = svc._encode

    def counted(params, u8):
        calls.append(u8.shape[0])
        return encode(params, u8)

    svc._encode = counted
    rids = [svc.submit_prepped(p) for p in prepped[:4]] + [svc.submit_embedding(emb)]
    rids += [svc.submit_array(im, max_length=4) for im in imgs[4:]]
    svc.drain()
    got = [svc.pop_result(r) for r in rids]
    assert sum(calls) == 7  # every image encoded once, the embedding never
    with pltpu.force_tpu_interpret_mode():
        jsvc = JContinuous(jmodel, jv, vcfg, **kw)
        jr = [jsvc.submit_prepped(p) for p in prepped[:4]] + [jsvc.submit_embedding(emb)]
        jr += [jsvc.submit_array(im, max_length=4) for im in imgs[4:]]
        jsvc.drain()
        want = [jsvc.pop_result(r) for r in jr]
    assert got == want
    fixed = CaptionService(tmodel, tv, tvcfg, policy=F32, batch_size=4, max_length=6)
    assert got[:4] == fixed.caption_prepped(np.stack(prepped[:4]))
    assert svc.caption_arrays(imgs[:3]) == fixed.caption_arrays(imgs[:3])


def _tower_configs():
    """Tiny towers at the production 224-pixel specs, so the extractors' own
    specs apply: (name, JAX config, port config)."""
    small = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                 num_attention_heads=4)
    return [
        ("clip", JCL.CLIPVisionConfig(**small, projection_dim=16),
         TCL.CLIPVisionConfig(**small, projection_dim=16)),
        ("vit", JVT.ViTConfig(**small, patch_size=32), TVT.ViTConfig(**small, patch_size=32)),
        ("dino", JDN.DINOv3Config(**small, patch_size=32, num_register_tokens=2,
                                  text_embed_dim=16),
         TDN.DINOv3Config(**small, patch_size=32, num_register_tokens=2, text_embed_dim=16)),
    ]


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    for i, im in enumerate(_imgs(5, seed=12)):
        Image.fromarray(im).save(d / f"COCO_val2017_{i:012d}.png")
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("name, jcfg, tcfg", _tower_configs(), ids=["clip", "vit", "dino"])
def test_extraction_matches_jax(name, jcfg, tcfg, png_dir, tmp_path):
    """``extract_*_embeddings`` over a directory of PNGs (5 images, batches of
    2: a padded tail) give the JAX extractor's names and embeddings, to
    1e-4; the ``.pt`` files interchange both ways."""
    jinit = {"clip": JCL.init_vision, "vit": JVT.init, "dino": JDN.init}[name]
    jparams = jinit(jax.random.PRNGKey(1), jcfg)
    tparams = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jfn = getattr(jextract, f"extract_{name}_embeddings")
    tfn = getattr(textract, f"extract_{name}_embeddings")
    jout, tout = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    jnames, jemb = jfn(png_dir, jout, jparams, jcfg, batch_size=2, num_workers=2, policy=JF32)
    tnames, temb = tfn(png_dir, tout, tparams, tcfg, batch_size=2, num_workers=2, policy=F32)
    assert tnames == jnames and len(tnames) == 5
    np.testing.assert_allclose(temb, jemb, atol=1e-4, rtol=1e-4)
    for reader, path in ((tio.load_embeddings, jout), (jio.load_embeddings, tout)):
        names, emb = reader(path)
        assert names == tnames and emb.dtype == np.float32
        np.testing.assert_array_equal(emb, temb if path == tout else jemb)
    with pytest.raises(NotImplementedError, match="queue 1: tensor parallelism"):
        tfn(png_dir, None, tparams, tcfg, mesh=TP2)
    # a one-rank mesh extracts as no mesh does, bit for bit
    names, emb = tfn(png_dir, None, tparams, tcfg, batch_size=2, num_workers=2, policy=F32,
                     mesh=create_mesh(device="cpu"))
    assert names == tnames
    np.testing.assert_array_equal(emb, temb)


def test_embeddings_io_npz_and_tensors(tmp_path):
    emb = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    path = str(tmp_path / "e.npz")
    tio.save_embeddings(path, ["a", "b", "c"], torch.from_numpy(emb))
    assert jio.load_embeddings(path)[0] == ["a", "b", "c"]
    names, got = tio.load_embeddings(path)
    assert names == ["a", "b", "c"]
    np.testing.assert_array_equal(got, emb)


def test_host_loaders_match_jax(png_dir):
    """The threaded PIL loader and the native pipeline's loader yield the JAX
    loaders' batches (fixed shape, the tail padded and masked)."""
    spec = TP.SPECS["vit"]
    jspec = JP.SPECS["vit"]
    got = list(timages.ImageBatchLoader(png_dir, TP.make_host_preprocess(spec), batch_size=2,
                                        num_workers=3))
    want = list(jimages.ImageBatchLoader(png_dir, JP.make_host_preprocess(jspec), batch_size=2,
                                         num_workers=3))
    assert len(got) == len(want) == 3
    for (gn, gb, gv), (wn, wb, wv) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gv, wv)
    assert got[-1][2].tolist() == [True, False]
    if tnative.available():
        native = list(tnative.NativeImageBatchLoader(png_dir, spec, batch_size=2))
        for (gn, gb, gv), (wn, wb, wv) in zip(native, want):
            assert gn == wn
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gv, wv)
