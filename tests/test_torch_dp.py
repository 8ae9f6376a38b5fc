"""The port's data parallelism against the JAX package's on a dp-2 mesh of
virtual CPU devices, in float32 at a tiny config (GPT-2 2 x 32 over the tiny
tokenizer's ids, the MLP mapper, the tiny CLIP tower), on the same weights.

One launch of two gloo ranks (subprocesses of ``tests/torch_dist_worker.py``,
each on the CPU with the weights the test wrote from the JAX trees) runs
every dp path once; the tests below split its results:

- the train step with accumulation 1 and 2, the ranks holding unequal
  numbers of real tokens (one rank's rows all padding in a step): loss rtol
  1e-5, parameters atol 1e-5 / rtol 1e-4 (``tests/test_torch_train.py``'s
  tolerances), both ranks' parameters bit-equal;
- ``train()`` for two epochs with evaluation, the last batch of each epoch
  mostly padding: the same epoch losses, trained leaves and metrics, and
  the artifacts written once;
- greedy, int8 and beam-4 ``generate`` on 5 rows (dp does not divide
  them): tokens exact; ``generate_predictions``;
- ``init_state_dp`` / ``macro_step_dp`` greedy: the packed outputs exact,
  macro by macro; ``ContinuousCaptionService`` and ``CaptionService``
  captions over the mesh;
- dp extraction: the ``.pt`` equal to one rank's;
- ``training_pipeline.run`` of a RAT config over a persistent store: rank 0
  alone writes the store, both ranks retrieve one process's images, and
  the losses and metrics equal the JAX ``run`` on its dp-2 mesh.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from gpt2_image_captioning_tpu import training_pipeline as jtp
from gpt2_image_captioning_tpu.core.config import Config as JConfig
from gpt2_image_captioning_tpu.core.mesh import MeshSpec, create_mesh
from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.data.dataset import CocoDataset as JCoco
from gpt2_image_captioning_tpu.evaluation.generation import generate_predictions as jpredict
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import continuous as JCE
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.retrieval.store import PersistentVectorStore as JPersistent
from gpt2_image_captioning_tpu.serving import CaptionService as JCaptionService
from gpt2_image_captioning_tpu.serving import ContinuousCaptionService as JContinuous
from gpt2_image_captioning_tpu.train import loop as JL
from gpt2_image_captioning_tpu.train import optim as JO
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.embeddings import extract as textract
from gpt2_image_captioning_tpu_torch.models import clip as TCL
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.retrieval.store import PersistentVectorStore

from helpers import make_synthetic_coco, tiny_tokenizer
from torch_dist_worker import launch

MAX_LEN = 6
LEN = 9
ENGINE = dict(slots=4, t_max=16, seg=2, bursts=2, admit=2, macros=4)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         tree)).items()}


def _batches(n, b, vocab, seed, padded_rows=()):
    """``n`` caption batches of ``b`` rows with ragged real lengths; the rows
    in ``padded_rows`` hold one real token (the second half of the batch is
    the second rank's shard, so the ranks' real-token counts differ)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(n, b, LEN)).astype(np.int32)
    lengths = rng.integers(3, LEN + 1, size=(n, b))
    lengths[:, list(padded_rows)] = 1
    mask = (np.arange(LEN) < lengths[..., None]).astype(np.int32)
    return {"token_ids": tokens, "labels": np.where(mask == 1, tokens, -100).astype(np.int32),
            "attention_mask": mask,
            "image_embedding": rng.normal(size=(n, b, 16)).astype(np.float32)}


def _rat_config(root, gkw, mkw) -> dict:
    """A RAT config at this size over a persistent store, on every rank of
    the group (``tpu.mesh`` dp -1), with the pipeline's files under
    ``root``: the train, val splits and the train split's caption
    embeddings (1-3 an image)."""
    for sub in ("embeddings", "annotations", "logs"):
        (root / sub).mkdir(parents=True)
    for split, n_img, ann in (("train", 10, "captions_train2017.json"),
                              ("val", 6, "captions_val2017.json")):
        e, a, _ = make_synthetic_coco(root, n_images=n_img, captions_per_image=2, prefix=split,
                                      seed=len(split), fmt="pt")
        os.rename(e, root / "embeddings" / f"{split}_clip_embeddings.pt")
        os.rename(a, root / "annotations" / ann)
    names = torch.load(root / "embeddings" / "train_clip_embeddings.pt")["filenames"]
    rng = np.random.default_rng(9)
    torch.save([{"filenames": f, "embeddings": [
        {"caption_id": 10 * i + c, "embedding": torch.from_numpy(
            rng.normal(size=16).astype(np.float32))} for c in range(1 + i % 3)]}
        for i, f in enumerate(names)], root / "embeddings" / "train_clip_caption_embeddings.pt")
    return {
        "seed": 0, "max_caption_length": 10, "vision_encoder": "clip",
        "retrieval_augmentation": True,
        "paths": {"data_dir": str(root) + "/", "embeddings_path": str(root / "embeddings") + "/",
                  "annotations_path": str(root / "annotations") + "/",
                  "checkpoints_path": str(root / "ckpt") + "/",
                  "vector_db_path": str(root / "db") + "/"},
        "mapping": {"type": "mlp", "embed_dim": mkw["embed_dim"], "gpt_dim": gkw["n_embd"],
                    "prefix_length": mkw["prefix_length"], "hidden_length": 2},
        "image_captioning": {"freeze_gpt_weights": True, "prefix_task_prompt": None},
        "retrieval": {"top_k": 4, "top_i": 2, "aggregation_type": "mean", "embed_dim": 16,
                      "backend": "persistent"},
        "training": {"batch_size": 8, "num_epochs": 1, "num_workers": 0, "learning_rate": 1e-3,
                     "num_warmup_steps": 0, "save_every_epoch": 1},
        "validation": {"eval_every_epoch": 1, "batch_size": 8, "temperature": 0.0,
                       "top_p": 1.0},
        "tpu": {"mesh": {"dp": -1, "tp": 1}, "compute_dtype": "float32", "grad_accum_steps": 1},
    }


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    tok = tiny_tokenizer()
    n = len(tok.encoder)
    gkw = dict(vocab_size=n, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=16, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=tok, rng=jax.random.PRNGKey(4))
    vcfg = JCL.CLIPVisionConfig.tiny()
    jv = JCL.init_vision(jax.random.PRNGKey(0), vcfg)
    # the extraction tower: tiny widths at the production 224-pixel spec
    xkw = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=4,
               projection_dim=16)
    jx = JCL.init_vision(jax.random.PRNGKey(1), JCL.CLIPVisionConfig(**xkw))
    weights = {f"{name}/{k}": v for name, tree in (("trainable", jmodel.trainable),
                                                   ("frozen", jmodel.frozen), ("vision", jv),
                                                   ("extract_tower", jx))
               for k, v in _flat(tree).items()}
    np.savez(root / "weights.npz", **weights)

    rng = np.random.default_rng(21)
    steps = _batches(3, 4, n, seed=1, padded_rows=(2, 3))
    steps["labels"][1, 2:] = -100  # a step where the second rank holds no real token
    group = _batches(2, 4, n, seed=2, padded_rows=(3,))
    q_per = 2
    engine_emb = rng.normal(size=(2 * q_per, 16)).astype(np.float32)
    inputs = {
        **{f"steps_{k}": v for k, v in steps.items()},
        **{f"group_{k}": v[None] for k, v in group.items()},
        "emb": rng.normal(size=(5, 16)).astype(np.float32),
        "engine_emb": engine_emb, "engine_cap": np.asarray([6, 3, 5, 6], np.int32),
        "engine_uid": np.asarray([0, 2, 1, 3], np.int32), "engine_n": np.asarray([2, 2]),
        "service_emb": rng.normal(size=(7, 16)).astype(np.float32),
        "prepped": rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8),
    }

    train_files = make_synthetic_coco(root, n_images=8, captions_per_image=3, prefix="train")
    val_files = make_synthetic_coco(root, n_images=5, captions_per_image=2, prefix="val", seed=1)
    png_dir = root / "pngs"
    png_dir.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, size=(40 + 5 * i, 36, 3), dtype=np.uint8)).save(
            png_dir / f"COCO_val2017_{i:012d}.png")
    rat_cfg = _rat_config(root / "rat", gkw, mkw)
    jrat = jtp.build_model(JConfig(rat_cfg), tok, gpt_config=JG.GPT2Config(**gkw))
    np.savez(root / "rat_weights.npz", **{f"{name}/{k}": v for name, tree in (
        ("trainable", jrat.trainable), ("frozen", jrat.frozen)) for k, v in _flat(tree).items()})
    queries = rng.normal(size=(3, 16)).astype(np.float32)
    inputs["rat_queries"] = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
    np.savez(root / "inputs.npz", **inputs)
    spec = {"gpt2": gkw, "mapping": mkw, "eos": n - 1, "vocab": dict(tok.encoder),
            "merges": sorted(tok.bpe_ranks, key=tok.bpe_ranks.get), "max_length": MAX_LEN,
            "coco": {"train_emb": train_files[0], "train_ann": train_files[1],
                     "val_emb": val_files[0], "val_ann": val_files[1]},
            "engine": ENGINE, "png_dir": str(png_dir), "extract_tower": xkw,
            "rat": {"config": rat_cfg, "dir": str(root / "rat"), "top_i": 2}}
    (root / "spec.json").write_text(json.dumps(spec))
    ranks = launch("dp", str(root))
    return {"root": root, "ranks": ranks, "jcfg": jcfg, "jmodel": jmodel, "tok": tok,
            "inputs": inputs, "spec": spec, "jv": jv, "vcfg": vcfg, "jx": jx,
            "mesh": create_mesh(MeshSpec(dp=2, tp=1), devices=jax.devices()[:2])}


def _close_trees(got: dict, want: dict, atol: float, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol, err_msg=k)


def test_ranks_run_on_a_gloo_mesh(dp):
    for r, got in enumerate(dp["ranks"]):
        assert got["mesh"] == {"dp": 2, "rank": r, "backend": "gloo"}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(dp, accum):
    """The dp train step divides by the global batch's token count: with the
    ranks' real tokens unequal (and none on one rank in a step) the losses,
    gradient norms and parameters equal the JAX step's on a dp-2 mesh, and
    the two ranks' parameters are bit-equal."""
    key = "steps" if accum == 1 else "group"
    names = ("token_ids", "labels", "attention_mask", "image_embedding")
    batches = dp["inputs"]
    mesh, jm = dp["mesh"], dp["jmodel"]
    opt = JO.AdamWConfig(learning_rate=1e-3, num_training_steps=4)
    jstep, (tr_sh, fr_sh, opt_sh, b_sh) = JL.make_train_step(dp["jcfg"], opt, mesh, JF32,
                                                             grad_accum_steps=accum)
    # the step donates its inputs: hand it copies of the façade's trees
    tr = jax.device_put(jax.tree.map(jnp.copy, jm.trainable), tr_sh)
    state = jax.device_put(JO.init(jm.trainable), opt_sh)
    fz = jax.device_put(jm.frozen, fr_sh)
    losses, norms = [], []
    for i in range(len(batches[f"{key}_labels"])):
        batch = jax.device_put({k: batches[f"{key}_{k}"][i] for k in names}, b_sh)
        tr, state, loss, norm = jstep(tr, state, fz, batch, {})
        losses.append(float(loss))
        norms.append(float(norm))
    r0, r1 = (r[f"step{accum}"] for r in dp["ranks"])
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r0["norms"], norms, rtol=1e-5)
    _close_trees(r0["trainable"], _flat(tr), atol=1e-5, rtol=1e-4)
    assert r0["losses"] == r1["losses"]
    for k, v in r0["trainable"].items():
        np.testing.assert_array_equal(v, r1["trainable"][k], err_msg=k)


@pytest.mark.parametrize("mode", ["greedy", "int8", "beam"])
def test_generate_matches_jax(dp, mode):
    """5 rows over 2 ranks (padded by the last row, dropped after the gather):
    every rank returns the JAX package's tokens — its dp-2 mesh for greedy
    and beams, and for int8 its single-device W8A8 kernel, which its own
    tests hold equal to the dp-sharded one."""
    jm, emb = dp["jmodel"], jnp.asarray(dp["inputs"]["emb"])
    kw = dict(max_length=MAX_LEN)
    if mode == "greedy":
        want = JC.generate(jm.trainable, jm.frozen, dp["jcfg"], emb, temperature=0.0,
                           mesh=dp["mesh"], **kw)
    elif mode == "beam":
        want = JC.beam_generate(jm.trainable, jm.frozen, dp["jcfg"], emb, beam_size=4,
                                mesh=dp["mesh"], **kw)
    else:
        tr, fz, pol = jm.decode_params("bf16")
        with pltpu.force_tpu_interpret_mode():
            want = JC.generate(tr, fz, dp["jcfg"], emb, temperature=0.0, policy=pol,
                               use_pallas_decode=True, decode_quant=True, **kw)
    for got in dp["ranks"]:
        assert got[mode].shape == (5, MAX_LEN)
        np.testing.assert_array_equal(got[mode], np.asarray(want))
    assert all(r["sampled_shape"] == (5, MAX_LEN) for r in dp["ranks"])


def test_generate_predictions_match_jax(dp):
    """Predictions gathered in global order without the padding rows, the
    same on both ranks and equal to the JAX function's on its dp-2 mesh."""
    val = JCoco(dp["spec"]["coco"]["val_emb"], dp["spec"]["coco"]["val_ann"],
                tokenizer=dp["tok"], max_length=10)
    want = jpredict(dp["jmodel"], val, batch_size=4, max_length=8, temperature=0.0,
                    mesh=dp["mesh"], verbose=False)
    assert len(want) == 5
    for got in dp["ranks"]:
        assert got["predictions"] == want


def test_train_loop_matches_jax(dp, tmp_path):
    """``train()`` over a dp-2 mesh, 24 captions in batches of 10 (each
    epoch's last batch holds 4 real rows, all on the first rank): the epoch
    losses, trained leaves and validation metrics of the JAX ``train()`` on
    its dp-2 mesh; rank 0 alone wrote the artifacts."""
    files = dp["spec"]["coco"]
    jtrain = JCoco(files["train_emb"], files["train_ann"], tokenizer=dp["tok"], max_length=10)
    jval = JCoco(files["val_emb"], files["val_ann"], tokenizer=dp["tok"], max_length=10)
    jm = JC.ImageCaptioningModel(dp["jcfg"], tokenizer=dp["tok"], rng=jax.random.PRNGKey(4))
    out = str(tmp_path / "jax")
    hist = JL.train(jtrain, jm, batch_size=10, num_epochs=2, learning_rate=1e-3,
                    save_every_epoch=1, outputs_dir=out, log_dir=os.path.join(out, "logs"),
                    val_dataset=jval, val_annotations_path=files["val_ann"], eval_batch_size=4,
                    eval_max_length=8, mesh=dp["mesh"])
    r0, r1 = (r["train"] for r in dp["ranks"])
    np.testing.assert_allclose(r0["epoch_losses"], hist["epoch_losses"], rtol=1e-5)
    _close_trees(r0["trainable"], _flat(jm.trainable), atol=1e-5, rtol=1e-4)
    for k, v in r0["trainable"].items():
        np.testing.assert_array_equal(v, r1["trainable"][k], err_msg=k)
    assert r0["best_epoch"] == r1["best_epoch"] == hist["best_epoch"]
    for got, want in zip(r0["val_metrics"], hist["val_metrics"]):
        assert got == pytest.approx(want, rel=1e-5)
    run = dp["root"] / "train"
    files = sorted(p.name for p in run.iterdir())
    assert {"model_epoch_1.npz", "model_epoch_2.npz", "optimizer_epoch_2.npz",
            "eval_results"} <= set(files)
    lines = (run / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len({ln for ln in lines})  # one writer: no line twice


def test_macro_step_dp_matches_jax(dp):
    """Two sub-pools of 2 rows, 4 staged requests (2 a pool), macros until
    both pools drain: the gathered packed outputs equal the JAX
    ``macro_step_dp``'s exactly, macro by macro, on both ranks."""
    jm, jcfg, inputs = dp["jmodel"], dp["jcfg"], dp["inputs"]
    p = jcfg.total_prefix_length
    state = JCE.init_state_dp(jcfg, 2, ENGINE["slots"], ENGINE["t_max"], p, JF32)
    outs = []
    with pltpu.force_tpu_interpret_mode():
        packed = JC.prepare_decode_weights(jm.trainable, jm.frozen, jcfg, policy=JF32)
        for m in range(ENGINE["macros"]):
            n_q = inputs["engine_n"] if m == 0 else np.zeros(2, np.int32)
            state, out = JCE.macro_step_dp(
                dp["mesh"], packed, jm.trainable, jm.frozen, state,
                jnp.asarray(inputs["engine_emb"]), jnp.asarray(inputs["engine_cap"]),
                jnp.asarray(inputs["engine_uid"]), jnp.asarray(n_q, jnp.int32), cfg=jcfg,
                policy=JF32, seg=ENGINE["seg"], bursts=ENGINE["bursts"], admit=ENGINE["admit"])
            outs.append(np.asarray(out))
    want = np.stack(outs)
    assert (want[-1, :, 1] == -1).all()  # drained
    for got in dp["ranks"]:
        assert got["engine_slots"] == (2, ENGINE["t_max"], 2, 32)
        np.testing.assert_array_equal(got["engine"], want)


def test_continuous_service_matches_jax(dp):
    """Seven embeddings through ``ContinuousCaptionService`` over the mesh
    (4 slots: 2 sub-pools) give the JAX service's captions on its dp-2
    mesh, on both ranks."""
    with pltpu.force_tpu_interpret_mode():
        svc = JContinuous(dp["jmodel"], None, None, slots=4, segment=2, bursts=2, admit=2,
                          max_length=MAX_LEN, mesh=dp["mesh"])
        ids = [svc.submit_embedding(e) for e in dp["inputs"]["service_emb"]]
        svc.drain()
        want = [svc.pop_result(i) for i in ids]
    for got in dp["ranks"]:
        assert got["continuous"] == want
        assert got["continuous_q"] == (svc.q_cap, svc.admit)


def test_caption_service_matches_jax(dp):
    """Six prepped images in device batches of 4 over the mesh: the JAX
    ``CaptionService``'s captions on its dp-2 mesh, on both ranks."""
    svc = JCaptionService(dp["jmodel"], dp["jv"], dp["vcfg"], encoder="clip", batch_size=4,
                          max_length=MAX_LEN, policy=JF32, mesh=dp["mesh"])
    want = svc.caption_prepped(dp["inputs"]["prepped"])
    for got in dp["ranks"]:
        assert got["captions"] == want


def test_extraction_equals_one_rank(dp, tmp_path):
    """The dp run's ``.pt`` (written by rank 0) holds the names and features
    of one process's extraction over the same directory; both ranks return
    them."""
    tx = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, dp["jx"]), device="cpu")
    names, emb = textract.extract_clip_embeddings(
        dp["spec"]["png_dir"], str(tmp_path / "one.pt"), tx,
        TCL.CLIPVisionConfig(**dp["spec"]["extract_tower"]), batch_size=4, num_workers=1,
        policy=F32)
    saved = torch.load(dp["root"] / "dp.pt", weights_only=False)
    assert saved["filenames"] == names and len(names) == 5
    np.testing.assert_allclose(np.asarray(saved["embeddings"]), emb, atol=1e-6, rtol=1e-6)
    for got in dp["ranks"]:
        assert got["extraction"][0] == names
        np.testing.assert_allclose(got["extraction"][1], emb, atol=1e-6, rtol=1e-6)


def test_rat_pipeline_persistent_store_matches_jax(dp, tmp_path, monkeypatch):
    """``training_pipeline.run`` with ``retrieval_augmentation`` and a
    persistent store over two ranks: rank 0 alone wrote the store's
    directory and the other rank opened it; both retrieve the images of the
    store opened in one process and of the JAX package's own persistent
    store; the epoch losses and validation metrics equal the JAX ``run`` on
    its dp-2 mesh, on the same weights."""
    rat = dp["spec"]["rat"]
    db = rat["config"]["paths"]["vector_db_path"]
    r0, r1 = (r["rat"] for r in dp["ranks"])
    assert r0["writes"] == [db] and r1["writes"] == []
    assert r0["store"] == r1["store"] == "PersistentVectorStore"
    queries = dp["inputs"]["rat_queries"]

    def ids(store):
        rows = store.retrieve_images_by_vector_similarity(queries, rat["top_i"])
        return [[name for name, _ in row] for row in rows]

    assert r0["retrieved"] == r1["retrieved"] == ids(PersistentVectorStore(db))
    assert all(len(row) == rat["top_i"] for row in r0["retrieved"])

    cfg = {**rat["config"], "paths": {**rat["config"]["paths"],
                                      "checkpoints_path": str(tmp_path / "ckpt") + "/",
                                      "vector_db_path": str(tmp_path / "db") + "/"}}
    gcfg = JG.GPT2Config(**dp["spec"]["gpt2"])
    build = jtp.build_model
    monkeypatch.setattr(jtp, "load_gpt2_tokenizer", lambda *a, **k: dp["tok"])
    monkeypatch.setattr(jtp, "build_model",
                        lambda c, t, **kw: build(c, t, gpt_config=gcfg, **kw))
    monkeypatch.setattr(jtp, "create_mesh",
                        lambda spec: create_mesh(spec, devices=jax.devices()[:2]))
    monkeypatch.chdir(tmp_path)
    hist = jtp.run(JConfig(cfg))
    assert ids(JPersistent(str(tmp_path / "db"))) == r0["retrieved"]
    np.testing.assert_allclose(r0["epoch_losses"], hist["epoch_losses"], rtol=1e-5)
    assert r0["epoch_losses"] == r1["epoch_losses"]
    assert len(r0["val_metrics"]) == len(hist["val_metrics"]) == 1
    for got in (r0, r1):
        assert got["val_metrics"][0] == pytest.approx(hist["val_metrics"][0], rel=1e-5)
