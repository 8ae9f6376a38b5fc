"""The port's tensor parallelism against the JAX package's, at
``tests/test_sharding.py``'s config (GPT-2 2 x 32 with 4 heads over the tiny
tokenizer's 267 ids, padded to 268 rows at tp 2 and 4; the MLP mapper;
GPT-2 unfrozen, so tp slices real gradients) and tolerances, the JAX side on
the conftest's virtual 8-device mesh.

One launch of four gloo ranks (``tests/torch_dist_worker.py``, task ``tp``)
runs the meshes (2, 2) and (1, 4); one of eight runs (2, 4).  Each holds:

- the train step at (2, 2) and (2, 4) against the JAX step on the same mesh:
  loss rel 1e-5, gradient norm rel 1e-4, parameters atol 1e-5;
- greedy tokens at (2, 2) and (1, 4), beam-2 tokens at (2, 2): exact;
  ``decode_quant`` / ``decode_quant_cache`` at tp decode as without them, as
  the JAX layerwise branch does, and warn;
- ``gather_params(shard_params(x)) == x`` bit for bit, and the slices'
  layout: whole heads of q, k and v on each rank, vocabulary rows padded;
- ``training_pipeline.run`` at ``tpu.mesh`` tp 2 over the four ranks: the
  JAX run's losses and metrics on its (2, 2) mesh; the run's checkpoint is
  a single-device one (same keys and shapes) and gives, loaded into the JAX
  package, the loss the port computes from it in one process and at tp;
- the dp-only services refuse a tp mesh with the JAX package's errors.
"""

import json
import os

import jax
import numpy as np
import pytest

from gpt2_image_captioning_tpu import training_pipeline as jtp
from gpt2_image_captioning_tpu.core.config import Config as JConfig
from gpt2_image_captioning_tpu.core.mesh import MeshSpec, batch_sharding, create_mesh
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.train import optim as JO
from gpt2_image_captioning_tpu.train.checkpoint import load_pytree
from gpt2_image_captioning_tpu.train.loop import _spec_to_sharding, make_train_step
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths

from helpers import make_synthetic_coco, tiny_tokenizer
from torch_dist_worker import launch

MAX_LEN = 6
GKW = dict(n_positions=32, n_embd=32, n_layer=2, n_head=4)
MKW = dict(prefix_length=2, embed_dim=16, gpt_dim=32)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         tree)).items()}


def _weights(path, trainable, frozen) -> None:
    np.savez(path, **{f"{name}/{k}": v for name, tree in (("trainable", trainable),
                                                          ("frozen", frozen))
                      for k, v in _flat(tree).items()})


@pytest.fixture(scope="module")
def setup():
    """``test_sharding.py``'s model and batch."""
    tok = tiny_tokenizer()
    gcfg = JG.GPT2Config(vocab_size=tok.vocab_size, **GKW)
    ccfg = JC.CaptionerConfig(gpt2=gcfg, mapping=JM.MLPMappingConfig(**MKW),
                              eos_token_id=tok.eos_token_id, freeze_gpt_weights=False)
    model = JC.ImageCaptioningModel(ccfg, tokenizer=tok, rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {
        "token_ids": rng.integers(0, tok.vocab_size - 1, size=(8, 10)).astype(np.int32),
        "labels": rng.integers(0, tok.vocab_size - 1, size=(8, 10)).astype(np.int32),
        "attention_mask": np.ones((8, 10), np.int32),
        "image_embedding": rng.normal(size=(8, 16)).astype(np.float32),
    }
    return {"tok": tok, "ccfg": ccfg, "model": model, "batch": batch,
            "host_tr": jax.tree.map(np.asarray, model.trainable)}


def _spec(setup, meshes) -> dict:
    tok = setup["tok"]
    return {"configs": {"sharding": {"gpt2": {"vocab_size": tok.vocab_size, **GKW},
                                     "mapping": MKW, "eos": tok.eos_token_id,
                                     "freeze": False}},
            "meshes": meshes, "max_length": MAX_LEN, "vocab": dict(tok.encoder),
            "merges": sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)}


def _run_config(root) -> dict:
    """A config.yml at this size with GPT-2 unfrozen over the group's ranks
    at ``tpu.mesh`` tp 2, its files under ``root``."""
    for sub in ("embeddings", "annotations", "logs"):
        (root / sub).mkdir(parents=True)
    for split, n_img, ann in (("train", 10, "captions_train2017.json"),
                              ("val", 6, "captions_val2017.json")):
        e, a, _ = make_synthetic_coco(root, n_images=n_img, captions_per_image=2, prefix=split,
                                      seed=len(split), fmt="pt")
        os.rename(e, root / "embeddings" / f"{split}_clip_embeddings.pt")
        os.rename(a, root / "annotations" / ann)
    return {
        "seed": 0, "max_caption_length": 10, "vision_encoder": "clip",
        "paths": {"data_dir": str(root) + "/", "embeddings_path": str(root / "embeddings") + "/",
                  "annotations_path": str(root / "annotations") + "/",
                  "checkpoints_path": str(root / "ckpt") + "/"},
        "mapping": {"type": "mlp", "embed_dim": 16, "gpt_dim": GKW["n_embd"],
                    "prefix_length": 2, "hidden_length": 2},
        "image_captioning": {"freeze_gpt_weights": False, "prefix_task_prompt": None},
        "training": {"batch_size": 8, "num_epochs": 2, "num_workers": 0, "learning_rate": 1e-3,
                     "num_warmup_steps": 0, "save_every_epoch": 1},
        "validation": {"eval_every_epoch": 1, "batch_size": 8, "temperature": 0.0,
                       "top_p": 1.0},
        "tpu": {"mesh": {"dp": -1, "tp": 2}, "compute_dtype": "float32", "grad_accum_steps": 1},
    }


def _launch(root, setup, meshes, world, run=None):
    spec = _spec(setup, meshes)
    _weights(root / "sharding.npz", setup["model"].trainable, setup["model"].frozen)
    np.savez(root / "inputs.npz", **{f"batch_{k}": v for k, v in setup["batch"].items()})
    if run is not None:
        spec["run"] = run
    (root / "spec.json").write_text(json.dumps(spec))
    return launch("tp", str(root), world=world, timeout=240.0)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, setup):
    root = tmp_path_factory.mktemp("tp4")
    cfg = _run_config(root / "run")
    jrun = jtp.build_model(JConfig(cfg), setup["tok"],
                           gpt_config=JG.GPT2Config(vocab_size=setup["tok"].vocab_size, **GKW))
    _weights(root / "run_weights.npz", jrun.trainable, jrun.frozen)
    run = {"config": cfg, "dir": str(root / "run"),
           "gpt2": {"vocab_size": setup["tok"].vocab_size, **GKW}}
    ranks = _launch(root, setup, [[2, 2, ["beam", "quant", "step"]], [1, 4, []]], 4, run)
    return {"root": root, "ranks": ranks, "run": run}


@pytest.fixture(scope="module")
def world8(tmp_path_factory, setup):
    return {"ranks": _launch(tmp_path_factory.mktemp("tp8"), setup, [[2, 4, ["step"]]], 8)}


def _jax_mesh(dp, tp):
    return create_mesh(MeshSpec(dp=dp, tp=tp))


def _jax_step(setup, dp, tp):
    """``test_sharding.py::_run`` on the (dp, tp) mesh."""
    mesh = _jax_mesh(dp, tp)
    opt_cfg = JO.AdamWConfig(learning_rate=1e-3, num_training_steps=4)
    step, (tr_sh, fr_sh, opt_sh, b_sh) = make_train_step(setup["ccfg"], opt_cfg, mesh,
                                                         setup["model"].policy)
    tr = jax.device_put(setup["host_tr"], tr_sh)
    fz = jax.device_put(setup["model"].frozen, fr_sh)
    o = jax.device_put(JO.init(tr), opt_sh)
    new_tr, _, loss, gnorm = step(tr, o, fz, jax.device_put(setup["batch"], b_sh), {})
    return float(loss), float(gnorm), _flat(new_tr)


def _jax_decode(setup, dp, tp, beam: bool):
    """``test_generate_invariant_to_tp_sharding`` / its beam case."""
    mesh = _jax_mesh(dp, tp)
    model, ccfg = setup["model"], setup["ccfg"]
    tr_specs, fr_specs = JC.partition_specs(ccfg)
    tr = jax.device_put(model.trainable, _spec_to_sharding(mesh, tr_specs))
    fz = jax.device_put(model.frozen, _spec_to_sharding(mesh, fr_specs))
    emb = jax.device_put(setup["batch"]["image_embedding"], batch_sharding(mesh))
    if beam:
        return np.asarray(JC.beam_generate(tr, fz, ccfg, emb, max_length=5, beam_size=2,
                                           mesh=mesh))
    return np.asarray(JC.generate(tr, fz, ccfg, emb, max_length=MAX_LEN, temperature=0.0,
                                  top_p=1.0, mesh=mesh))


def _ranks(world4, world8, key):
    return (world4 if key != "2x4" else world8)["ranks"]


@pytest.mark.parametrize("dp, tp", [(2, 2), (2, 4)])
def test_step_matches_jax_step(setup, world4, world8, dp, tp):
    """``test_step_invariant_to_mesh``: the port's tp step on every rank
    against the JAX step on the same mesh."""
    loss, gnorm, params = _jax_step(setup, dp, tp)
    ranks = _ranks(world4, world8, f"{dp}x{tp}")
    for got in (r[f"{dp}x{tp}"]["step"] for r in ranks):
        assert got["loss"] == pytest.approx(loss, rel=1e-5), "loss differs under tp"
        assert got["norm"] == pytest.approx(gnorm, rel=1e-4), "grad norm differs under tp"
        assert sorted(got["trainable"]) == sorted(params)
        for k, v in params.items():
            np.testing.assert_allclose(got["trainable"][k], v, atol=1e-5, err_msg=k)
    assert len({r[f"{dp}x{tp}"]["step"]["loss"] for r in ranks}) == 1


@pytest.mark.parametrize("dp, tp", [(2, 2), (1, 4)])
def test_generate_matches_jax_tp(setup, world4, dp, tp):
    """``test_generate_invariant_to_tp_sharding``: greedy tokens exact on
    every rank."""
    want = _jax_decode(setup, dp, tp, beam=False)
    for got in world4["ranks"]:
        np.testing.assert_array_equal(got[f"{dp}x{tp}"]["greedy"], want)


def test_beam_generate_matches_jax_tp(setup, world4):
    """``test_beam_generate_invariant_to_tp_sharding`` at (2, 2)."""
    want = _jax_decode(setup, 2, 2, beam=True)
    for got in world4["ranks"]:
        np.testing.assert_array_equal(got["2x2"]["beam"], want)


def test_decode_quant_at_tp_decodes_as_the_jax_branch(world4):
    """At tp the JAX ``generate`` takes its layerwise branch, which reads
    neither ``decode_quant`` nor ``decode_quant_cache``: the port decodes the
    same greedy tokens with them, and says so in a warning."""
    for got in world4["ranks"]:
        np.testing.assert_array_equal(got["2x2"]["quant"], got["2x2"]["greedy"])
        assert any("decode_quant" in w for w in got["2x2"]["quant_warnings"])
        assert got["2x2"]["sampled_shape"] == (8, MAX_LEN)


@pytest.mark.parametrize("key", ["2x2", "1x4", "2x4"])
def test_slices_round_trip_and_layout(setup, world4, world8, key):
    """``gather_params(shard_params(x))`` is ``x`` bit for bit; each rank's
    ``c_attn`` holds the same whole heads of q, k and v, its ``c_fc`` a
    column block, its ``c_proj`` a row block, and its ``wte`` a block of
    the vocabulary rows padded with zeros to a multiple of tp."""
    tp = int(key.split("x")[1])
    full = _flat(setup["model"].trainable)
    d, v = GKW["n_embd"], setup["tok"].vocab_size
    wte = np.concatenate([full["gpt.wte"], np.zeros((-v % tp, d), np.float32)])
    for got in _ranks(world4, world8, key):
        got = got[key]
        assert got["round_trip"]
        t = got["coords"][1]
        cols = slice(t * d // tp, (t + 1) * d // tp)
        s = got["slices"]
        qkv = full["gpt.blocks.attn.c_attn.w"]
        want = np.concatenate([qkv[..., j * d:(j + 1) * d][..., cols] for j in range(3)], -1)
        np.testing.assert_array_equal(s["gpt.blocks.attn.c_attn.w"], want)
        fc = slice(t * 4 * d // tp, (t + 1) * 4 * d // tp)
        np.testing.assert_array_equal(s["gpt.blocks.mlp.c_fc.w"],
                                      full["gpt.blocks.mlp.c_fc.w"][..., fc])
        np.testing.assert_array_equal(s["gpt.blocks.mlp.c_proj.w"],
                                      full["gpt.blocks.mlp.c_proj.w"][:, fc])
        np.testing.assert_array_equal(s["gpt.blocks.attn.c_proj.b"],
                                      full["gpt.blocks.attn.c_proj.b"])
        rows = wte.shape[0] // tp
        np.testing.assert_array_equal(s["gpt.wte"], wte[t * rows:(t + 1) * rows])


def test_pipeline_run_at_tp2_matches_jax(setup, world4, tmp_path, monkeypatch):
    """``training_pipeline.run`` with ``tpu.mesh`` tp 2 over four ranks (dp
    2): the epoch losses and validation metrics of the JAX ``run`` on its
    (2, 2) mesh, on every rank; rank 0 alone wrote the run's log."""
    cfg = world4["run"]["config"]
    cfg = {**cfg, "paths": {**cfg["paths"], "checkpoints_path": str(tmp_path / "ckpt") + "/"}}
    gcfg = JG.GPT2Config(vocab_size=setup["tok"].vocab_size, **GKW)
    build = jtp.build_model
    monkeypatch.setattr(jtp, "load_gpt2_tokenizer", lambda *a, **k: setup["tok"])
    monkeypatch.setattr(jtp, "build_model", lambda c, t, **kw: build(c, t, gpt_config=gcfg, **kw))
    monkeypatch.setattr(jtp, "create_mesh",
                        lambda spec: create_mesh(spec, devices=jax.devices()[:4]))
    monkeypatch.chdir(tmp_path)
    hist = jtp.run(JConfig(cfg))
    for got in (r["run"] for r in world4["ranks"]):
        np.testing.assert_allclose(got["epoch_losses"], hist["epoch_losses"], rtol=1e-5)
        assert len(got["val_metrics"]) == len(hist["val_metrics"]) == 2
        for g, w in zip(got["val_metrics"], hist["val_metrics"]):
            assert g == pytest.approx(w, rel=1e-5)
    lines = (world4["root"] / "run" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert lines and len(lines) == len(set(lines))  # one writer: no line twice


def test_tp_checkpoint_is_a_single_device_checkpoint(setup, world4):
    """The tp run's ``model_epoch_2.npz`` (rank 0's, gathered from the
    slices) has the keys and shapes of a single-device save, its optimizer
    state too, and loaded into the JAX package gives the loss the port
    computes from the trained model in one process and at tp."""
    ckpt = world4["root"] / "run" / "ckpt"
    gcfg = JG.GPT2Config(vocab_size=setup["tok"].vocab_size, **GKW)
    jm = jtp.build_model(JConfig(world4["run"]["config"]), setup["tok"], gpt_config=gcfg)
    shapes = {k: v.shape for k, v in _flat(jm.trainable).items()}
    saved = _flat(load_pytree(str(ckpt / "model_epoch_2.npz")))
    assert {k: v.shape for k, v in saved.items()} == shapes
    moments = _flat(load_pytree(str(ckpt / "optimizer_epoch_2.npz")))
    assert {k[len("mu."):]: v.shape for k, v in moments.items() if k.startswith("mu.")} == shapes
    jm.load_saved_parameters(str(ckpt / "model_epoch_2.npz"))
    batch = {k: np.asarray(v) for k, v in setup["batch"].items()}
    want = float(JC.mean_loss(jm.trainable, jm.frozen, jm.cfg, batch, jm.policy))
    for got in (r["run"] for r in world4["ranks"]):
        assert got["loss_one_process"] == pytest.approx(want, rel=1e-5)
        assert got["loss_tp"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("key", ["2x2", "1x4", "2x4"])
def test_conjugate_pair_and_gather(world4, world8, key):
    """Megatron's pair over a rank's tp group (each rank's input ``(t + 1) ·
    x``): ``reduce_from_tp`` sums the inputs and passes the gradient
    through; ``copy_to_tp`` passes the input through and sums the ranks'
    gradients; ``gather_last_tp`` concatenates the inputs on the last dim
    and hands each rank its own columns of the gradient."""
    tp = int(key.split("x")[1])
    x = np.arange(6.0).reshape(2, 3)
    total = tp * (tp + 1) / 2
    weight = np.arange(6.0 * tp).reshape(2, 3 * tp)
    for got in _ranks(world4, world8, key):
        t = got[key]["coords"][1]
        y, g = got[key]["pair"]["reduce"]
        np.testing.assert_array_equal(y, total * x)
        np.testing.assert_array_equal(g, np.arange(6.0).reshape(2, 3))
        y, g = got[key]["pair"]["copy"]
        np.testing.assert_array_equal(y, (t + 1) * x)
        np.testing.assert_array_equal(g, np.full((2, 3), total))
        y, g = got[key]["pair"]["gather"]
        np.testing.assert_array_equal(y, np.concatenate([(r + 1) * x for r in range(tp)], -1))
        np.testing.assert_array_equal(g, weight[:, 3 * t:3 * (t + 1)])


def test_dp_only_paths_refuse_tp_with_the_jax_errors(world4):
    """``ContinuousCaptionService`` and extraction over a real tp mesh raise
    the JAX package's ``ValueError``s word for word."""
    for got in world4["ranks"]:
        assert got["refusals"] == ["ContinuousCaptionService meshes must be dp-only",
                                   "extraction meshes must be dp-only (tp=1)"]
