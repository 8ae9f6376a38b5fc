"""The port's CLIP text half against the JAX package's on the CPU, float32:
``CLIPBPETokenizer`` ids on the synthetic assets of
``test_clip_tokenizer.py``, ``encode_text`` on JAX weights carried across
(``text_from_jax_numpy``) to 1e-5, ``port_clip_text`` of an HF-named state
dict, and the word-embeddings artifact (``extract_caption_embeddings``):
the same grouping and caption ids, embeddings to 1e-5, and the JAX
package's ``load_caption_entries`` reading the port's file."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.data import tokenizer as JT
from gpt2_image_captioning_tpu.embeddings import word_embeddings as JW
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import porting as JP
from gpt2_image_captioning_tpu.retrieval.rat_pipeline import load_caption_entries
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.data import tokenizer as TT
from gpt2_image_captioning_tpu_torch.embeddings import word_embeddings as TW
from gpt2_image_captioning_tpu_torch.models import clip as TCL
from gpt2_image_captioning_tpu_torch.models import porting as TP

from test_clip_tokenizer import _build_assets

SAMPLES = ["the cat", "The CAT sat", "a   dog  here", "it's 12 dogs", "punctuation, yes!",
           "", "the dog at the cat " * 12]  # the last one past 77 tokens


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    vf, mf = _build_assets(tmp_path_factory.mktemp("clip_assets"))
    return JT.CLIPBPETokenizer.from_files(vf, mf), TT.CLIPBPETokenizer.from_files(vf, mf)


@pytest.mark.parametrize("native", [True, False])
def test_tokenizer_ids_match_jax(toks, native, monkeypatch):
    jtok, _ = toks
    if not native:
        monkeypatch.setenv("GIC_DISABLE_NATIVE_BPE", "1")
    ttok = TT.CLIPBPETokenizer(jtok.encoder, sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get))
    for s in SAMPLES:
        assert ttok.encode(s) == jtok.encode(s), s
        assert ttok.encode(s, add_special_tokens=False) == jtok.encode(s, add_special_tokens=False)
    got, want = ttok(SAMPLES), jtok(SAMPLES)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32 and got[k].shape == (len(SAMPLES), 77)
    assert got["input_ids"][-1, -1] == ttok.eos_token_id  # truncation keeps EOS last
    assert (ttok.bos_token_id, ttok.eos_token_id, ttok.pad_token_id) == \
        (jtok.bos_token_id, jtok.eos_token_id, jtok.pad_token_id)
    assert ttok.merge_loop == ("python" if not native or ttok._native is None else "native")
    assert TT._clip_whitespace_clean("  a \n b\t") == JT._clip_whitespace_clean("  a \n b\t")


def test_load_clip_tokenizer(toks, tmp_path, monkeypatch):
    vf, _ = _build_assets(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("CLIP_TOKENIZER_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="CLIP_TOKENIZER_DIR"):
        TT.load_clip_tokenizer()
    monkeypatch.setenv("CLIP_TOKENIZER_DIR", str(tmp_path))
    assert TT.load_clip_tokenizer().encode("the cat") == toks[0].encode("the cat")


def _tower(vocab: int, seed: int = 0):
    cfg = JCL.CLIPTextConfig.tiny(vocab_size=vocab)
    jp = JCL.init_text(jax.random.PRNGKey(seed), cfg)
    tcfg = TCL.CLIPTextConfig.tiny(vocab_size=vocab)
    assert tcfg == TCL.CLIPTextConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return cfg, jp, tcfg, TP.text_from_jax_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_encode_text_matches_jax(toks):
    """Ragged captions (pooled at each first EOT, padding after it), a row
    cut before its EOT (pooled at position 0, as argmax gives), normalised
    and not."""
    jtok, ttok = toks
    cfg, jp, tcfg, tp = _tower(len(jtok.encoder))
    ids = ttok(SAMPLES)["input_ids"][:, : cfg.max_position_embeddings]
    for normalize in (True, False):
        want = JCL.encode_text(jp, cfg, jnp.asarray(ids), policy=JF32, normalize=normalize)
        got = TCL.encode_text(tp, tcfg, torch.from_numpy(ids), policy=F32, normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(SAMPLES), 16)
    g = TCL.init_text(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, g)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, jp))


def test_port_clip_text_matches_jax():
    """An HF-named CLIP text state dict (with the vision keys a full
    CLIPModel also holds) through both packages' ``port_clip_text``."""
    cfg = JCL.CLIPTextConfig.tiny(vocab_size=50)
    rng = np.random.default_rng(2)
    d, inter, proj = cfg.hidden_size, cfg.intermediate_size, cfg.projection_dim
    sd = {"text_model.embeddings.token_embedding.weight": (cfg.vocab_size, d),
          "text_model.embeddings.position_embedding.weight": (cfg.max_position_embeddings, d),
          "text_model.final_layer_norm.weight": (d,), "text_model.final_layer_norm.bias": (d,),
          "text_projection.weight": (proj, d), "visual_projection.weight": (proj, 8)}
    for i in range(cfg.num_hidden_layers):
        p = f"text_model.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            sd.update({f"{p}.{n}.weight": (d,), f"{p}.{n}.bias": (d,)})
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update({f"{p}.self_attn.{n}.weight": (d, d), f"{p}.self_attn.{n}.bias": (d,)})
        sd.update({f"{p}.mlp.fc1.weight": (inter, d), f"{p}.mlp.fc1.bias": (inter,),
                   f"{p}.mlp.fc2.weight": (d, inter), f"{p}.mlp.fc2.bias": (d,)})
    sd = {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}
    want = JP.port_clip_text(sd, cfg)
    got = TP.port_clip_text({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), got))[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(flat_g[path], np.asarray(leaf), err_msg=str(path))
    ids = rng.integers(0, cfg.vocab_size, size=(3, 9))
    ids[:, 6] = cfg.eos_token_id
    tcfg = TCL.CLIPTextConfig.tiny(vocab_size=50)
    np.testing.assert_allclose(
        TCL.encode_text(got, tcfg, torch.from_numpy(ids)).numpy(),
        np.asarray(JCL.encode_text(want, cfg, jnp.asarray(ids))), atol=1e-5, rtol=1e-5)


def _annotations(path, n_images=5, seed=0):
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "dog", "at", "a", "sat", "here", "12"]
    images = [{"id": 40 + i, "file_name": f"COCO_train2017_{40 + i:012d}.jpg"} for i in range(4)]
    images.append({"id": 99})  # no file_name: COCO's zero-padded name
    anns, aid = [], 500
    for order in rng.permutation(np.repeat(np.arange(n_images), 3)):
        img = images[int(order)]
        anns.append({"image_id": img["id"], "id": aid,
                     "caption": " ".join(rng.choice(words, size=rng.integers(1, 9)))})
        aid += 1
    path.write_text(json.dumps({"images": images, "annotations": anns}))
    return str(path)


@pytest.mark.parametrize("batch_size", [4, 32])
def test_word_embeddings_artifact_matches_jax(toks, tmp_path, batch_size):
    jtok, ttok = toks
    ann = _annotations(tmp_path / "captions.json")
    cfg, jp, tcfg, tp = _tower(len(jtok.encoder), seed=1)
    want = JW.extract_caption_embeddings(ann, None, jp, cfg, jtok, batch_size=batch_size,
                                         policy=JF32)
    out = str(tmp_path / "caption_embeddings.pt")
    got = TW.extract_caption_embeddings(ann, out, tp, tcfg, ttok, batch_size=batch_size,
                                        policy=F32)
    assert [g["filenames"] for g in got] == [w["filenames"] for w in want]
    assert "000000000099.jpg" in [g["filenames"] for g in got]
    for g, w in zip(got, want):
        assert [e["caption_id"] for e in g["embeddings"]] == \
            [e["caption_id"] for e in w["embeddings"]]
        np.testing.assert_allclose(np.stack([e["embedding"].numpy() for e in g["embeddings"]]),
                                   np.stack([np.asarray(e["embedding"]) for e in w["embeddings"]]),
                                   atol=1e-5)
    read = load_caption_entries(out)  # the JAX package's reader
    assert [r["filenames"] for r in read] == [g["filenames"] for g in got]
    for r, g in zip(read, got):
        for re_, ge in zip(r["embeddings"], g["embeddings"]):
            assert re_["caption_id"] == ge["caption_id"]
            assert isinstance(re_["embedding"], torch.Tensor) and re_["embedding"].dtype == \
                torch.float32 and torch.equal(re_["embedding"], ge["embedding"])
    mapping = TW.map_caption_id_to_caption(ann)
    assert mapping == JW.map_caption_id_to_caption(ann) and len(mapping) == 15
