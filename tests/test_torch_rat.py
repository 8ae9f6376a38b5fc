"""Retrieval-augmented training in the port against the JAX package's
(``models/rat.py``, ``train/loop.py::train_rat``, RAT evaluation) on the
CPU, float32, on the same weights (carried across with
``porting.from_jax_numpy``, the aggregator included):

- the four aggregators to 1e-6;
- ``loss_fn`` (host store: retrieved embeddings in the batch) and
  ``loss_fn_fused`` (the device store's arrays): loss to 1e-5, gradients of
  the mapper and the aggregator to 1e-4;
- ``train_rat`` over 2 epochs with the device store (attention, evaluation
  each epoch through the store) and the flat store (mean): epoch losses to
  1e-5, trained leaves to 1e-5, the same validation captions;
- RAT ``generate`` and ``generate_predictions`` tokens exact, greedy and beam;
- the reference's checkpoint quirk kept: a ``.pt`` checkpoint holds no
  aggregator, so loading one keeps the model's own (an ``.npz`` carries it).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.mesh import MeshSpec, create_mesh
from gpt2_image_captioning_tpu.data.dataset import CocoDataset as JCoco
from gpt2_image_captioning_tpu.evaluation import generation as JGen
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.models import rat as JR
from gpt2_image_captioning_tpu.retrieval import exact as JE
from gpt2_image_captioning_tpu.retrieval import store as JS
from gpt2_image_captioning_tpu.train import loop as JL
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset as TCoco
from gpt2_image_captioning_tpu_torch.data.embeddings_io import load_embeddings
from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer
from gpt2_image_captioning_tpu_torch.evaluation import generation as TGen
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.models import rat as TR
from gpt2_image_captioning_tpu_torch.retrieval import exact as TE
from gpt2_image_captioning_tpu_torch.retrieval import store as TS
from gpt2_image_captioning_tpu_torch.train import loop as TL

from helpers import make_synthetic_coco, tiny_tokenizer

EMB = 16
TRAIN = dict(batch_size=8, learning_rate=1e-3, save_every_epoch=1)
GKW = dict(n_positions=64, n_embd=32, n_layer=1, n_head=2)
MAPPERS = {
    "mlp": (JM.MLPMappingConfig(prefix_length=2, embed_dim=EMB, gpt_dim=32),
            TM.MLPMappingConfig(prefix_length=2, embed_dim=EMB, gpt_dim=32)),
    "transformer": (JM.TransformerMappingConfig(EMB, 32, 3, 4, num_layers=1, num_heads=4),
                    TM.TransformerMappingConfig(EMB, 32, 3, 4, num_layers=1, num_heads=4)),
}


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """8 train images x 3 captions, 5 val images x 2, and a caption store
    over the train images: 0-5 caption embeddings an image (the queries are
    the train images, so each drops itself)."""
    root = tmp_path_factory.mktemp("rat")
    jtok = tiny_tokenizer()
    ttok = GPT2BPETokenizer(jtok.encoder, sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get))
    train_files = make_synthetic_coco(root, n_images=8, captions_per_image=3, prefix="train")
    val_files = make_synthetic_coco(root, n_images=5, captions_per_image=2, prefix="val", seed=1)
    names, img = load_embeddings(train_files[0])
    rng = np.random.default_rng(7)
    entries, cid = [], 0
    for f, n in zip(names, [3, 0, 5, 1, 4, 2, 5, 3]):
        embs = [{"caption_id": cid + j, "embedding": torch.from_numpy(v)}
                for j, v in enumerate(_unit(rng, n, EMB))]
        cid += n
        entries.append({"filenames": f, "embeddings": embs})
    return {
        "root": root, "jtok": jtok, "ttok": ttok, "names": names, "img": img,
        "entries": entries, "val_ann": val_files[1],
        "jtrain": JCoco(*train_files[:2], tokenizer=jtok, max_length=10),
        "ttrain": TCoco(*train_files[:2], tokenizer=ttok, max_length=10),
        "jval": JCoco(*val_files[:2], tokenizer=jtok, max_length=10),
        "tval": TCoco(*val_files[:2], tokenizer=ttok, max_length=10),
        "mesh": create_mesh(MeshSpec(dp=1, tp=1), devices=jax.devices()[:1]),
    }


def configs(s, mapper):
    jm, tm = MAPPERS[mapper]
    v = s["jtok"].vocab_size
    return (JC.CaptionerConfig(gpt2=JG.GPT2Config(vocab_size=v, **GKW), mapping=jm,
                               eos_token_id=s["jtok"].eos_token_id),
            TC.CaptionerConfig(gpt2=TG.GPT2Config(vocab_size=v, **GKW), mapping=tm,
                               eos_token_id=s["ttok"].eos_token_id))


def models(s, rcfg, mapper="mlp", seed=0):
    """(JAX RAT model, the port's over its weights)."""
    jcfg, tcfg = configs(s, mapper)
    jrcfg = JR.RATConfig(**dataclasses.asdict(rcfg))
    j = JR.RetrievalAugmentedTransformer(jrcfg, jcfg, tokenizer=s["jtok"],
                                         rng=jax.random.PRNGKey(seed))
    t = TR.RetrievalAugmentedTransformer(rcfg, tcfg, tokenizer=s["ttok"], device="cpu")
    assert sorted(t.trainable) == sorted(j.trainable)
    t.trainable, t.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (j.trainable, j.frozen)), tcfg, device="cpu")
    back, _ = porting.to_numpy(t.trainable, t.frozen)
    for k, v in flatten_with_paths(back).items():  # the aggregator carried both ways
        np.testing.assert_array_equal(v, np.asarray(flatten_with_paths(j.trainable)[k]))
    return j, t


def stores(s, backend):
    args = (s["names"], s["img"], s["entries"])
    if backend == "device":
        return JE.DeviceVectorStore.build(*args), TE.DeviceVectorStore.build(*args, device="cpu")
    return JS.create_store(*args, backend=backend), TS.create_store(*args, backend=backend)


@pytest.mark.parametrize("kind", TR.AGGREGATION_TYPES)
def test_aggregators_match_jax(kind):
    rng = np.random.default_rng(1)
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type=kind)
    jparams = JR.init_aggregator(jax.random.PRNGKey(2), JR.RATConfig(EMB, kind))
    tparams = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    q = rng.normal(size=(5, EMB)).astype(np.float32)
    r = rng.normal(size=(5, 7, EMB)).astype(np.float32)
    r[1] = 0.0  # an all-zero retrieval: sum_norm's clamps at 1e-12
    r[2, 3:] = 0.0  # zero-padded rows
    want = JR.aggregate(jparams, JR.RATConfig(EMB, kind), jnp.asarray(q), jnp.asarray(r))
    got = TR.aggregate(tparams, rcfg, torch.from_numpy(q), torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert sorted(tparams) == (["attention_proj"] if kind == "attention" else [])
    g = TR.init_aggregator(torch.Generator().manual_seed(0), rcfg, device="cpu")
    assert jax.tree.map(lambda a: a.shape, jparams) == jax.tree.map(lambda t: tuple(t.shape), g)
    with pytest.raises(ValueError, match="aggregation_type"):
        TR.aggregate({}, TR.RATConfig(aggregation_type="median"), torch.from_numpy(q),
                     torch.from_numpy(r))


def _batch(s, idx):
    return {k: v for k, v in s["ttrain"].gather_batch(np.asarray(idx)).items() if k != "image_id"}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind", ["attention", "sum_norm"])
def test_losses_and_gradients_match_jax(setup, fused, kind):
    """One batch through the fused (device store) or the host-store loss:
    loss to 1e-5, the mapper's and the aggregator's gradients to 1e-4."""
    s = setup
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type=kind, top_k=6, top_i=3)
    j, t = models(s, rcfg, "transformer", seed=3)
    batch = _batch(s, np.arange(0, 24, 3))
    jstore, tstore = stores(s, "device")
    if not fused:
        batch["retrieved_embeddings"] = TR.retrieve(rcfg, tstore, batch["image_embedding"])
        np.testing.assert_array_equal(
            batch["retrieved_embeddings"].numpy(),
            np.asarray(jstore.retrieve_fused(jnp.asarray(batch["image_embedding"]), 3, 6)))
    jb = {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()}
    jextra = {"image_embeddings": jstore.image_embeddings,
              "caption_embeddings": jstore.caption_embeddings,
              "caption_table": jstore.caption_table}
    jrcfg = j.rcfg.__class__(**dataclasses.asdict(rcfg))

    def jloss(tr):
        if fused:
            s_, c = JR.loss_fn_fused(tr, j.frozen, j.cfg, jrcfg, jb, jextra)
        else:
            s_, c = JR.loss_fn(tr, j.frozen, j.cfg, jrcfg, jb)
        return s_ / c

    want, jgrads = jax.value_and_grad(jloss)(j.trainable)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    params = flatten_with_paths(t.trainable)
    for p in params.values():
        p.requires_grad_(True)
    if fused:
        s_, c = TR.loss_fn_fused(t.trainable, t.frozen, t.cfg, rcfg, tb, tstore.arrays())
    else:
        s_, c = TR.loss_fn(t.trainable, t.frozen, t.cfg, rcfg, tb)
    got = s_ / c
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(params)
    assert any(k.startswith("aggregator.") for k in params) == (kind == "attention")
    for k, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), jflat[k], atol=1e-4, rtol=1e-4, err_msg=k)
        p.requires_grad_(False)


def _train_pair(s, backend, kind, **kw):
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type=kind, top_k=4, top_i=2)
    j, t = models(s, rcfg, seed=5)
    jstore, tstore = stores(s, backend)
    runs = {}
    for name, fn, model, store, ds, extra in (
            ("jax", JL.train_rat, j, jstore, s["jtrain"], dict(mesh=s["mesh"])),
            ("port", TL.train_rat, t, tstore, s["ttrain"], dict(device="cpu"))):
        out = str(s["root"] / f"{backend}_{kind}_{name}")
        runs[name] = fn(ds, model, store, top_k=6, top_i=3, num_epochs=2, outputs_dir=out,
                        log_dir=os.path.join(out, "logs"), **TRAIN, **kw, **extra)
    return j, t, runs


def _assert_trained_equal(j, t):
    got = {k: v.detach().numpy() for k, v in flatten_with_paths(t.trainable).items()}
    want = flatten_with_paths(jax.tree.map(np.asarray, j.trainable))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_train_rat_device_store_matches_jax(setup):
    """Two epochs with the fused retrieval and the attention aggregator: the
    same losses and weights, then the same validation captions through the
    store."""
    s = setup
    j, t, runs = _train_pair(s, "device", "attention", val_dataset=None)
    np.testing.assert_allclose(runs["port"]["epoch_losses"], runs["jax"]["epoch_losses"],
                               rtol=1e-5)
    _assert_trained_equal(j, t)
    kw = dict(batch_size=4, max_length=8, temperature=0.0, verbose=False, top_k=6, top_i=3)
    jstore, tstore = stores(s, "device")
    want = JGen.generate_predictions(j, s["jval"], db_store=jstore, **kw)
    got = TGen.generate_predictions(t, s["tval"], db_store=tstore, device="cpu", **kw)
    assert got == want


def test_train_rat_flat_store_matches_jax(setup):
    """Two epochs with the host flat store (retrieval prefetched by a
    thread) and the mean aggregator: the same losses and weights."""
    s = setup
    j, t, runs = _train_pair(s, "flat", "mean", val_dataset=None)
    np.testing.assert_allclose(runs["port"]["epoch_losses"], runs["jax"]["epoch_losses"],
                               rtol=1e-5)
    _assert_trained_equal(j, t)


def test_train_rat_evaluates_through_the_store(setup, tmp_path):
    """``train`` with a validation split: each epoch's captions are the RAT
    model's through the store, written as ``epoch_{n}_val_predictions_rat``."""
    s = setup
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type="mean", top_k=4, top_i=2)
    _, t = models(s, rcfg, seed=6)
    _, tstore = stores(s, "device")
    out = str(tmp_path / "run")
    hist = TL.train_rat(s["ttrain"], t, tstore, top_k=6, top_i=3, num_epochs=1, device="cpu",
                        outputs_dir=out, log_dir=os.path.join(out, "logs"), val_dataset=s["tval"],
                        val_annotations_path=s["val_ann"], eval_batch_size=4, eval_max_length=8,
                        eval_temperature=0.0, **TRAIN)
    files = sorted(os.listdir(os.path.join(out, "eval_results")))
    assert "epoch_1_val_predictions_rat.json" in files and "epoch_1_val_metrics_rat.json" in files
    assert len(hist["val_metrics"]) == 1
    want = TGen.generate_predictions(t, s["tval"], batch_size=4, max_length=8, temperature=0.0,
                                     db_store=tstore, top_k=6, top_i=3, verbose=False,
                                     device="cpu")
    import json

    assert json.load(open(os.path.join(out, "eval_results",
                                       "epoch_1_val_predictions_rat.json"))) == want
    with pytest.raises(ValueError, match="together"):
        TL.train(s["ttrain"], t, num_epochs=1, device="cpu", rat_cfg=rcfg, outputs_dir=out,
                 **TRAIN)


@pytest.mark.parametrize("backend", ["device", "flat", "hnsw"])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_rat_generation_matches_jax(setup, backend, mode):
    """The façade's ``generate(db_store=)`` and ``generate_predictions`` with
    a store: tokens and captions equal to the JAX package's."""
    s = setup
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type="attention", top_k=5, top_i=2)
    j, t = models(s, rcfg, seed=8)
    j.frozen = dict(j.frozen, gpt=dict(j.frozen["gpt"], wpe=j.frozen["gpt"]["wpe"] * 8.0))
    _, t.frozen = porting.from_jax_numpy(*jax.tree.map(np.asarray, (j.trainable, j.frozen)),
                                         t.cfg, device="cpu")
    jstore, tstore = stores(s, backend)
    kw = (dict(decode="beam", beam_size=3) if mode == "beam" else dict(temperature=0.0))
    want = JGen.generate_predictions(j, s["jval"], batch_size=4, max_length=8, verbose=False,
                                     db_store=jstore, top_k=4, top_i=3, **kw)
    got = TGen.generate_predictions(t, s["tval"], batch_size=4, max_length=8, verbose=False,
                                    db_store=tstore, top_k=4, top_i=3, device="cpu", **kw)
    assert got == want
    plain = TGen.generate_predictions(t, s["tval"], batch_size=4, max_length=8, verbose=False,
                                      device="cpu", **kw)
    assert plain != got  # the retrieval changed the captions
    if mode == "greedy":
        emb = s["img"][:5]
        want_ids = j.generate(jnp.asarray(emb), db_store=jstore, max_length=8, temperature=0.0)
        got_ids = t.generate(emb, db_store=tstore, max_length=8, temperature=0.0)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        aug = t.augment(emb, tstore)  # rcfg's depths
        np.testing.assert_allclose(
            aug.numpy(), np.asarray(JR.augment_batch(j.trainable, j.rcfg, jstore, emb)),
            atol=1e-6)
    with pytest.raises(TypeError, match="retrieval-augmented"):
        plain_model = TC.ImageCaptioningModel(t.cfg, tokenizer=s["ttok"], device="cpu")
        TGen.generate_predictions(plain_model, s["tval"], db_store=tstore, device="cpu")


@pytest.mark.parametrize("ext", ["pt", "npz"])
def test_checkpoint_aggregator_quirk(setup, tmp_path, ext):
    """The reference's checkpoint format names no aggregator: a ``.pt``
    checkpoint loads the mapper and keeps the model's own aggregator (a
    RAT model rebuilt for the sweep's test pass keeps its fresh one, drawn
    from seed + 1), as the JAX package does; an ``.npz`` carries it."""
    s = setup
    rcfg = TR.RATConfig(embed_dim=EMB, aggregation_type="attention")
    j, t = models(s, rcfg, seed=9)
    path = str(tmp_path / f"ckpt.{ext}")
    t.save_parameters(path)
    j.save_parameters(str(tmp_path / f"jax.{ext}"))
    saved = {k: v.clone() for k, v in flatten_with_paths(t.trainable).items()}
    _, fresh = models(s, rcfg, seed=10)
    own = {k: v.clone() for k, v in flatten_with_paths(fresh.trainable).items()}
    j_fresh, _ = models(s, rcfg, seed=10)
    for model, p in ((fresh, path), (j_fresh, str(tmp_path / f"jax.{ext}"))):
        model.load_saved_parameters(p)
    got = flatten_with_paths(fresh.trainable)
    jgot = flatten_with_paths(jax.tree.map(np.asarray, j_fresh.trainable))
    for k, v in got.items():
        expect = own[k] if (k.startswith("aggregator.") and ext == "pt") else saved[k]
        assert torch.equal(v, expect), k
        np.testing.assert_allclose(v.numpy(), jgot[k], atol=1e-7, err_msg=k)
    wrapped = TR.RetrievalAugmentedTransformer.wrap(
        TC.ImageCaptioningModel(t.cfg, device="cpu"), rcfg, seed=43)
    again = TR.init_aggregator(torch.Generator().manual_seed(43), rcfg, device="cpu")
    assert torch.equal(wrapped.trainable["aggregator"]["attention_proj"]["w"],
                       again["attention_proj"]["w"])


def test_prefetched_keeps_order_and_reraises():
    """The host-store retrieval's thread: items in order, computed ahead of
    the consumer; an error in the thread re-raises in the consumer after
    the items before it."""
    seen = []

    def transform(i):
        seen.append(i)
        if i == 4:
            raise KeyError("store")
        return i * 10

    it = TL._prefetched(iter(range(8)), transform, depth=2)
    assert next(it) == 0
    got = [next(it) for _ in range(3)]
    assert got == [10, 20, 30]
    with pytest.raises(KeyError, match="store"):
        next(it)
    assert seen == [0, 1, 2, 3, 4]
    assert list(TL._prefetched(iter([]), transform)) == []
