"""The port's data and evaluation modules against the JAX package's, on the
JAX tests' own fixtures (``helpers.tiny_tokenizer``, ``make_synthetic_coco``):

- ``CocoDataset`` (``.npz`` and ``.pt`` embeddings) gives equal arrays —
  token ids, labels, mask, embeddings, image ids — and equal
  ``unique_image_batches`` with their ``valid`` masks; the ``Batcher`` over
  it gives equal batches; ``split_coco_annotations`` writes equal JSON; the
  missing-embedding ``KeyError`` is raised;
- the tokenizer's native and plain-Python merge loops give equal ids;
- ``Bleu``, ``Rouge`` and ``Cider`` equal the JAX package's to 1e-12 (corpus
  and per item) on the adversarial corpus of ``test_metrics_oracles.py``
  and meet its frozen goldens; the ``evaluate.py`` functions write the same
  files with the same JSON;
- ``generate_predictions`` and ``evaluate_epoch`` in float32 on the same
  weights return equal predictions and metrics, greedy and beam-4, with a
  padded last batch; sampling at a one-token nucleus is greedy, a repeated
  seed repeats itself, and int8 equals the façade's own int8 ``generate``;
- the façade's ``forward`` equals ``mean_loss`` and the JAX ``forward``, and
  ``save_parameters`` → ``load_saved_parameters`` round-trips and renews
  the decode caches.

The port runs its plain twins on the CPU.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.data import dataset as JD
from gpt2_image_captioning_tpu.evaluation import evaluate as JE
from gpt2_image_captioning_tpu.evaluation import generation as JGen
from gpt2_image_captioning_tpu.evaluation import metrics as JMet
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch.core.mesh import Mesh, create_mesh
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.data import dataset as TD
from gpt2_image_captioning_tpu_torch.data import native_bpe
from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer
from gpt2_image_captioning_tpu_torch.evaluation import evaluate as TE
from gpt2_image_captioning_tpu_torch.evaluation import generation as TGen
from gpt2_image_captioning_tpu_torch.evaluation import metrics as TMet
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

from helpers import make_synthetic_coco, tiny_tokenizer
from test_metrics_oracles import SYNTH_GOLDENS, synthetic_corpus

N_IMAGES, EVAL_BATCH, MAX_LEN = 8, 3, 8  # 8 images in batches of 3: the last one padded


def port_tokenizer(jtok) -> GPT2BPETokenizer:
    """The port's tokenizer over a JAX tokenizer's vocabulary and merges."""
    return GPT2BPETokenizer(jtok.encoder, sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Synthetic COCO (8 images x 3 captions) in both embedding formats,
    with the JAX and the port tokenizer over the same tables."""
    files = {fmt: make_synthetic_coco(tmp_path_factory.mktemp(fmt), n_images=N_IMAGES,
                                      captions_per_image=3, fmt=fmt)[:2]
             for fmt in ("npz", "pt")}
    jtok = tiny_tokenizer()
    return files, jtok, port_tokenizer(jtok)


def _datasets(coco, fmt="npz", **kw):
    files, jtok, ttok = coco
    emb, ann = files[fmt]
    return (JD.CocoDataset(emb, ann, tokenizer=jtok, **kw),
            TD.CocoDataset(emb, ann, tokenizer=ttok, **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
@pytest.mark.parametrize("max_length, normalize", [(10, False), (4, True)])
def test_coco_dataset_matches_jax(coco, fmt, max_length, normalize):
    jds, tds = _datasets(coco, fmt, max_length=max_length, normalize_embeddings=normalize)
    assert len(tds) == len(jds) == 3 * N_IMAGES
    assert tds.image_filenames == jds.image_filenames
    assert tds.image_id_to_index == jds.image_id_to_index
    for name in ("token_ids", "labels", "attention_mask", "image_embeddings",
                 "embedding_indices", "image_ids"):
        got, want = getattr(tds, name), getattr(jds, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (tds.labels[tds.attention_mask == 0] == -100).all()
    if max_length == 10:  # captions of 3-5 words + EOS: some rows are padded
        assert (tds.attention_mask == 0).any()
    else:  # truncated before the EOS
        assert tds.attention_mask.all()
    for i in (0, 5, len(tds) - 1):
        g, w = tds[i], jds[i]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    idx = np.array([3, 0, 17, 3])
    _assert_batches_equal([tds.gather_batch(idx)], [jds.gather_batch(idx)])
    got = list(tds.unique_image_batches(EVAL_BATCH))
    _assert_batches_equal(got, list(jds.unique_image_batches(EVAL_BATCH)))
    assert [int(b["valid"].sum()) for b in got] == [3, 3, 2]
    assert [int(i) for b in got for i, v in zip(b["image_id"], b["valid"]) if v] == \
        list(dict.fromkeys(int(i) for i in tds.image_ids))  # first-seen order, each once


def test_batcher_over_coco_matches_jax(coco):
    jds, tds = _datasets(coco, max_length=10)
    ours, theirs = TD.Batcher(tds, 5, seed=1), JD.Batcher(jds, 5, seed=1)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 5
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        _assert_batches_equal(got, list(theirs.epoch(epoch)))
        assert (got[-1]["labels"][4:] == -100).all()  # 24 = 4 x 5 + 4 real rows


def test_split_coco_annotations_matches_jax(coco, tmp_path):
    _, ann = coco[0]["npz"]
    TD.split_coco_annotations(ann, str(tmp_path / "port"), split_ratio=0.75, seed=3)
    JD.split_coco_annotations(ann, str(tmp_path / "jax"), split_ratio=0.75, seed=3)
    for name in ("train_split.json", "val_split.json"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
    train = json.loads((tmp_path / "port" / "train_split.json").read_text())
    val = json.loads((tmp_path / "port" / "val_split.json").read_text())
    assert (len(train["images"]), len(val["images"])) == (6, 2)
    assert not {a["image_id"] for a in train["annotations"]} & {a["image_id"] for a in
                                                                val["annotations"]}


def test_missing_embedding_raises(coco, tmp_path):
    files, _, ttok = coco
    emb, ann = files["npz"]
    data = json.loads(open(ann).read())
    data["annotations"].append({"image_id": 999, "id": 10 ** 6, "caption": "a dog"})
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(data))
    with pytest.raises(KeyError, match="1 annotation image ids have no embedding"):
        TD.CocoDataset(emb, str(bad), tokenizer=ttok)
    assert TD.CocoDataset.get_image_id_from_filename("COCO_train2014_000000123456.jpg") == 123456
    assert TD.CocoDataset.get_image_id_from_filename("000000000042.jpg") == 42


TEXTS = ["the cat on the dog", "a dog at the cat<|endoftext|>", "Hello,  wörld! 12 ☃ the",
         "  leading and trailing  ", "<|endoftext|>", "catcatdog thethe"]


@pytest.mark.parametrize("vocab", ["tiny", "fabricated_50257"])
def test_native_and_plain_merge_loops_agree(vocab, tmp_path, monkeypatch):
    """The native engine where ``libbpe.so`` is built (as the JAX package's
    own test of it), the plain loop with it disabled; both equal the JAX
    tokenizer's ids."""
    if vocab == "tiny":
        jtok = tiny_tokenizer()
        make = lambda: port_tokenizer(jtok)  # noqa: E731
    else:
        from fabricate_assets import fabricate_gpt2_vocab
        from gpt2_image_captioning_tpu.data.tokenizer import GPT2BPETokenizer as JTok

        fabricate_gpt2_vocab(str(tmp_path))
        files = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
        jtok = JTok.from_files(*files)
        make = lambda: GPT2BPETokenizer.from_files(*files)  # noqa: E731
    monkeypatch.setenv("GIC_DISABLE_NATIVE_BPE", "1")
    plain = make()
    want = [plain.encode(t) for t in TEXTS]
    assert plain.merge_loop == "python"
    assert want == [jtok.encode(t) for t in TEXTS]
    if not native_bpe.available():
        pytest.skip("native/build/libbpe.so not built (make -C native)")
    monkeypatch.delenv("GIC_DISABLE_NATIVE_BPE")
    native = make()
    assert native.merge_loop is None
    assert [native.encode(t) for t in TEXTS] == want
    assert native.merge_loop == "native"


def _corpus(name):
    if name == "adversarial":
        return synthetic_corpus()
    return synthetic_corpus(n_images=40, seed=3)


@pytest.mark.parametrize("corpus", ["adversarial", "adversarial_seed3"])
def test_metrics_match_jax(corpus):
    gts, res = _corpus(corpus)
    for ours, theirs in ((TMet.Bleu(4), JMet.Bleu(4)), (TMet.Rouge(), JMet.Rouge()),
                         (TMet.Cider(), JMet.Cider())):
        got, got_items = ours.compute_score(gts, res)
        want, want_items = theirs.compute_score(gts, res)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=ours.method())
        np.testing.assert_allclose(np.asarray(got_items), np.asarray(want_items), rtol=1e-12,
                                   atol=1e-12, err_msg=ours.method())
    if corpus == "adversarial":
        np.testing.assert_allclose(TMet.Bleu(4).compute_score(gts, res)[0], SYNTH_GOLDENS["bleu"],
                                   rtol=1e-12)
        assert TMet.Rouge().compute_score(gts, res)[0] == pytest.approx(SYNTH_GOLDENS["rouge_l"],
                                                                        rel=1e-12)
        assert TMet.Cider().compute_score(gts, res)[0] == pytest.approx(SYNTH_GOLDENS["cider"],
                                                                        rel=1e-12)


def _predictions(coco):
    """One caption per image, some exact references, some not."""
    _, ann = coco[0]["npz"]
    refs = JE.load_coco_references(ann)
    return [{"image_id": iid, "caption": caps[0] if i % 2 else "a cat on the dog"}
            for i, (iid, caps) in enumerate(refs.items())], ann


def _tree_files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_evaluate_functions_write_the_same_files(coco, tmp_path):
    preds, ann = _predictions(coco)
    assert TE.load_coco_references(ann) == JE.load_coco_references(ann)
    got, want = TE.evaluate_captions(preds, ann), JE.evaluate_captions(preds, ann)
    assert got.to_dict() == pytest.approx(want.to_dict(), rel=1e-12, abs=0)
    assert str(got) == str(want)
    for pkg, mod, metrics in (("port", TE, got), ("jax", JE, want)):
        for rat in (False, True):
            mod.save_epoch_artifacts(preds, metrics, str(tmp_path / pkg), 3, "val", rat=rat)
        mod.save_eval_summary([{"epoch": 3, "loss": 1.5, **metrics.to_dict()}],
                              str(tmp_path / pkg / "summary.json"))
    files = _tree_files(tmp_path / "port")
    assert sorted(files) == sorted(_tree_files(tmp_path / "jax")) == sorted(
        ["epoch_3_val_predictions.json", "epoch_3_val_metrics.json",
         "epoch_3_val_predictions_rat.json", "epoch_3_val_metrics_rat.json", "summary.json"])
    for name, data in files.items():
        assert json.loads(data) == json.loads((tmp_path / "jax" / name).read_bytes()), name
    got_items, want_items = TE.per_image_metrics(preds, ann), JE.per_image_metrics(preds, ann)
    assert sorted(got_items) == sorted(want_items)
    for iid in want_items:
        assert got_items[iid] == pytest.approx(want_items[iid], rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError, match="No common image IDs"):
        TE.compute_caption_metrics({1: ["a"]}, {2: ["a"]})


# ---------------------------------------------------------------------------
# Generation and evaluation on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(coco):
    """The JAX façade and the port's over the same float32 weights: GPT-2
    2 x 32 over the tiny tokenizer's 267 ids, the MLP mapper (16 → 2 x 32);
    the position embeddings scaled by 8 so that the images' captions part
    early (and beams part from the greedy path)."""
    _, jtok, ttok = coco
    gkw = dict(vocab_size=jtok.vocab_size, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=16, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=jtok.eos_token_id)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=ttok.eos_token_id)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=jtok, rng=jax.random.PRNGKey(4))
    jmodel.frozen = dict(jmodel.frozen, gpt=dict(jmodel.frozen["gpt"],
                                                 wpe=jmodel.frozen["gpt"]["wpe"] * 8.0))
    tmodel = TC.ImageCaptioningModel(tcfg, tokenizer=ttok, device="cpu")
    tmodel.trainable, tmodel.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (jmodel.trainable, jmodel.frozen)), tcfg, device="cpu")
    return jmodel, tmodel


GEN_MODES = {"greedy": dict(decode="sample", temperature=0.0),
             "beam4": dict(decode="beam", beam_size=4)}
# a mesh with a tensor-parallel axis, which the port refuses
TP2 = Mesh(dp=1, tp=2, rank=0, world_size=1, group=None, backend=None,
           device=torch.device("cpu"))


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_generate_predictions_match_jax(coco, models, mode):
    jmodel, tmodel = models
    jds, tds = _datasets(coco, max_length=10)
    kw = dict(batch_size=EVAL_BATCH, max_length=MAX_LEN, verbose=False, **GEN_MODES[mode])
    want = JGen.generate_predictions(jmodel, jds, **kw)
    got = TGen.generate_predictions(tmodel, tds, device="cpu", **kw)
    assert got == want
    assert [p["image_id"] for p in got] == list(dict.fromkeys(int(i) for i in tds.image_ids))
    assert len({p["caption"] for p in got}) > 1


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_evaluate_epoch_matches_jax(coco, models, mode, tmp_path):
    jmodel, tmodel = models
    jds, tds = _datasets(coco, max_length=10)
    ann = coco[0]["npz"][1]
    kw = dict(epoch=2, split_name="val", batch_size=EVAL_BATCH, max_length=MAX_LEN,
              temperature=0.0, **{k: v for k, v in GEN_MODES[mode].items() if k != "temperature"})
    want = JGen.evaluate_epoch(jmodel, jds, ann, output_dir=str(tmp_path / "jax"), **kw)
    got = TGen.evaluate_epoch(tmodel, tds, ann, output_dir=str(tmp_path / "port"), device="cpu",
                              **kw)
    assert got.to_dict() == pytest.approx(want.to_dict(), rel=1e-12, abs=0)
    files = _tree_files(tmp_path / "port")
    assert sorted(files) == sorted(_tree_files(tmp_path / "jax")) == [
        "epoch_2_val_metrics.json", "epoch_2_val_predictions.json"]
    for name, data in files.items():
        assert json.loads(data) == json.loads((tmp_path / "jax" / name).read_bytes()), name


def test_sampled_predictions(coco, models):
    """A one-token nucleus draws the argmax: greedy's captions; a repeated
    seed repeats the draws, another seed draws others."""
    _, tmodel = models
    _, tds = _datasets(coco, max_length=10)
    kw = dict(batch_size=EVAL_BATCH, max_length=MAX_LEN, verbose=False, device="cpu")
    greedy = TGen.generate_predictions(tmodel, tds, temperature=0.0, **kw)
    assert TGen.generate_predictions(tmodel, tds, temperature=1.0, top_p=1e-6, seed=3,
                                     **kw) == greedy
    first = TGen.generate_predictions(tmodel, tds, temperature=1.5, top_p=1.0, seed=5, **kw)
    assert TGen.generate_predictions(tmodel, tds, temperature=1.5, top_p=1.0, seed=5,
                                     **kw) == first
    assert TGen.generate_predictions(tmodel, tds, temperature=1.5, top_p=1.0, seed=6,
                                     **kw) != first
    assert TGen.batch_seed(5, 0) != TGen.batch_seed(5, 1) != TGen.batch_seed(6, 1)


@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_int8_predictions_equal_the_facade(coco, models, mode):
    """int8 decodes through the façade's W8A8 pack: the first batch's
    captions equal the façade's own int8 ``generate`` (greedy) or
    ``beam_generate`` on the W8A8 pack of the bf16 copy."""
    _, tmodel = models
    _, tds = _datasets(coco, max_length=10)
    got = TGen.generate_predictions(tmodel, tds, batch_size=EVAL_BATCH, max_length=MAX_LEN,
                                    decode_precision="int8", verbose=False, device="cpu",
                                    **GEN_MODES[mode])
    batch = next(tds.unique_image_batches(EVAL_BATCH))
    if mode == "greedy":
        ids = tmodel.generate(batch["image_embedding"], max_length=MAX_LEN, temperature=0.0,
                              decode_precision="int8")
    else:
        tr, fz, pol, packed, quant = tmodel.decode_pack("int8")
        assert quant and "qkvs" in packed
        ids = TC.beam_generate(tr, fz, tmodel.cfg, torch.from_numpy(batch["image_embedding"]),
                               max_length=MAX_LEN, beam_size=4, policy=pol, packed=packed,
                               decode_quant=True)
    want = tmodel.tokenizer.batch_decode(ids.numpy(), skip_special_tokens=True)
    assert [p["caption"] for p in got[:EVAL_BATCH]] == want


def test_generate_test_caption_predictions_writes_results(coco, models, tmp_path):
    _, tmodel = models
    _, tds = _datasets(coco, max_length=10)
    out = tmp_path / "sub" / "results.json"
    preds = TGen.generate_test_caption_predictions(tmodel, tds, str(out), batch_size=EVAL_BATCH,
                                                   max_length=MAX_LEN, device="cpu")
    assert json.loads(out.read_text()) == preds
    assert len(preds) == N_IMAGES


@pytest.mark.parametrize("option", [dict(mesh=TP2)])
def test_unported_options_raise(coco, models, option):
    _, tmodel = models
    _, tds = _datasets(coco, max_length=10)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
        TGen.generate_predictions(tmodel, tds, device="cpu", **option)



@pytest.mark.parametrize("mode", list(GEN_MODES))
def test_one_rank_mesh_predicts_as_no_mesh(coco, models, mode, tmp_path):
    """``generate_predictions`` and ``evaluate_epoch`` on a one-rank mesh:
    the predictions without a mesh, bit for bit, and the same metrics and
    files."""
    _, tmodel = models
    _, tds = _datasets(coco, max_length=10)
    kw = dict(batch_size=EVAL_BATCH, max_length=MAX_LEN, verbose=False, device="cpu",
              **GEN_MODES[mode])
    one = create_mesh(device="cpu")
    assert TGen.generate_predictions(tmodel, tds, mesh=one, **kw) == \
        TGen.generate_predictions(tmodel, tds, **kw)
    ann = coco[0]["npz"][1]
    ekw = dict(epoch=2, split_name="val", **{k: v for k, v in kw.items() if k != "verbose"})
    got = TGen.evaluate_epoch(tmodel, tds, ann, output_dir=str(tmp_path / "mesh"), mesh=one,
                              **ekw)
    want = TGen.evaluate_epoch(tmodel, tds, ann, output_dir=str(tmp_path / "none"), **ekw)
    assert got.to_dict() == want.to_dict()
    assert _tree_files(tmp_path / "mesh") == _tree_files(tmp_path / "none")

def _rat_wrapped(models, coco, aggregation):
    """Both façades wrapped as RAT models (the JAX package's way: the same
    trees, an aggregator added; ``attention``'s carried across) and a
    device store over the images' own embeddings with 0-4 random caption
    vectors an image."""
    from gpt2_image_captioning_tpu.models import rat as JR
    from gpt2_image_captioning_tpu.retrieval import exact as JEx
    from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
    from gpt2_image_captioning_tpu_torch.models import rat as TR
    from gpt2_image_captioning_tpu_torch.retrieval import exact as TEx

    jmodel, tmodel = models
    jr = JR.RetrievalAugmentedTransformer.__new__(JR.RetrievalAugmentedTransformer)
    jr.__dict__.update(jmodel.__dict__, trainable=dict(jmodel.trainable))
    jr.rcfg = JR.RATConfig(embed_dim=16, aggregation_type=aggregation, top_k=4, top_i=2)
    agg = JR.init_aggregator(jax.random.PRNGKey(1), jr.rcfg)
    if agg:
        jr.trainable["aggregator"] = agg
    base = copy.copy(tmodel)  # the fixture's façade keeps its own trees
    base.trainable = dict(tmodel.trainable)
    tr = TR.RetrievalAugmentedTransformer.wrap(
        base, TR.RATConfig(embed_dim=16, aggregation_type=aggregation, top_k=4, top_i=2), 1)
    tr.trainable = porting.from_jax_numpy(jax.tree.map(np.asarray, jr.trainable), tmodel.frozen,
                                          tmodel.cfg, device="cpu")[0]
    names, img = load_embeddings(coco[0]["npz"][0])
    rng = np.random.default_rng(3)
    entries = [{"filenames": f, "embeddings": [
        {"caption_id": 10 * i + c, "embedding": torch.from_numpy(rng.normal(size=16)
                                                                  .astype(np.float32))}
        for c in range(i % 5)]} for i, f in enumerate(names)]
    return (jr, tr, JEx.DeviceVectorStore.build(names, img, entries),
            TEx.DeviceVectorStore.build(names, img, entries, device="cpu"))


@pytest.mark.parametrize("option", ["db_store", "top_k", "top_i"])
def test_rat_options_run_and_match_jax(coco, models, option):
    """``db_store``: each batch augmented through the store before the
    decode (the attention aggregator), the captions equal to the JAX
    package's and not the plain ones; with ``decode_precision="bf16"`` the
    augmentation stays at the model's float32 and only the decode is bf16;
    ``top_k`` / ``top_i`` without a store are ignored, as there."""
    jds, tds = _datasets(coco, max_length=10)
    kw = dict(batch_size=EVAL_BATCH, max_length=MAX_LEN, temperature=0.0, verbose=False)
    plain = TGen.generate_predictions(models[1], tds, device="cpu", **kw)
    if option != "db_store":
        got = TGen.generate_predictions(models[1], tds, device="cpu", **{option: 2}, **kw)
        assert got == plain == JGen.generate_predictions(models[0], jds, **{option: 2}, **kw)
        return
    jr, tr, jstore, tstore = _rat_wrapped(models, coco, "attention")
    want = JGen.generate_predictions(jr, jds, db_store=jstore, top_k=3, top_i=2, **kw)
    got = TGen.generate_predictions(tr, tds, db_store=tstore, top_k=3, top_i=2, device="cpu",
                                    **kw)
    assert got == want and got != plain
    # bf16: the float32 augmentation, then the façade's bf16 decode of it
    got = TGen.generate_predictions(tr, tds, db_store=tstore, top_k=3, top_i=2,
                                    decode_precision="bf16", device="cpu", **kw)
    batch = next(tds.unique_image_batches(EVAL_BATCH))
    aug = tr.augment(batch["image_embedding"], tstore, top_k=3, top_i=2)
    assert aug.dtype == torch.float32
    ids = tr.generate(aug, max_length=MAX_LEN, temperature=0.0, decode_precision="bf16")
    assert [p["caption"] for p in got[:EVAL_BATCH]] == \
        tr.tokenizer.batch_decode(ids.numpy(), skip_special_tokens=True)


# ---------------------------------------------------------------------------
# The façade
# ---------------------------------------------------------------------------

def test_forward_matches_mean_loss_and_jax(coco, models):
    jmodel, tmodel = models
    jds, tds = _datasets(coco, max_length=10)
    idx = np.arange(6)
    batch = tds.gather_batch(idx)
    got = tmodel.forward(batch)
    want = TC.mean_loss(tmodel.trainable, tmodel.frozen, tmodel.cfg,
                        {k: torch.as_tensor(v) for k, v in batch.items() if k != "image_id"})
    assert torch.equal(got, want)
    np.testing.assert_allclose(float(got), float(jmodel.forward(jds.gather_batch(idx))),
                               rtol=1e-5)
    kw = dict(caption_token_ids=batch["token_ids"], image_embeddings=batch["image_embedding"])
    np.testing.assert_allclose(float(tmodel.forward(**kw)), float(jmodel.forward(**kw)),
                               rtol=1e-5)
    kw.update(attention_mask=batch["attention_mask"], labels=batch["labels"])
    assert torch.equal(tmodel.forward(**kw), got)


@pytest.mark.parametrize("ext", ["npz", "pt"])
def test_save_and_load_round_trip_renews_decode_caches(coco, models, ext, tmp_path):
    _, tmodel = models
    ttok = coco[2]
    path = str(tmp_path / f"model.{ext}")
    tmodel.save_parameters(path)
    other = TC.ImageCaptioningModel(tmodel.cfg, tokenizer=ttok,
                                    generator=torch.Generator().manual_seed(9), device="cpu")
    other.frozen = tmodel.frozen
    emb = next(_datasets(coco, max_length=10)[1].unique_image_batches(EVAL_BATCH))[
        "image_embedding"]
    stale = {p: other.decode_pack(p) for p in ("bf16", "int8")}
    before = other.generate(emb, max_length=MAX_LEN, temperature=0.0, decode_precision="bf16")
    other.load_saved_parameters(path)
    got, want = flatten_with_paths(other.trainable), flatten_with_paths(tmodel.trainable)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for precision, (tr, _, _, packed, _) in stale.items():
        new_tr, _, _, new_packed, _ = other.decode_pack(precision)
        assert new_tr is not tr and new_packed is not packed
        for k, v in flatten_with_paths(new_tr).items():
            assert torch.equal(v, want[k].to(torch.bfloat16)), k
    after = other.generate(emb, max_length=MAX_LEN, temperature=0.0, decode_precision="bf16")
    assert torch.equal(after, tmodel.generate(emb, max_length=MAX_LEN, temperature=0.0,
                                              decode_precision="bf16"))
    assert not torch.equal(after, before)


def test_utils_match_jax(models, tmp_path):
    from gpt2_image_captioning_tpu import utils as JU
    from gpt2_image_captioning_tpu_torch import utils as TU

    jmodel, tmodel = models
    assert TU.count_model_parameters(tmodel) == JU.count_model_parameters(jmodel)
    assert [TU.get_max_workers(b) for b in (1, 7, 4096)] == \
        [JU.get_max_workers(b) for b in (1, 7, 4096)]
    assert TU.plotting_available()
    history = [{"epoch": e, "loss": 1.0 / e, "BLEU-1": 0.1 * e, "BLEU-4": 0.01 * e,
                "ROUGE-L": 0.2, "CIDEr": 0.3 * e} for e in (1, 2)]
    TU.save_loss_curves([2.0, 1.5], str(tmp_path / "loss.png"))
    TU.save_eval_metric_curves(history, str(tmp_path / "metrics.png"))
    TU.save_eval_metric_curves([], str(tmp_path / "none.png"))
    assert sorted(os.listdir(tmp_path)) == ["loss.png", "metrics.png"]
    for name in os.listdir(tmp_path):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
