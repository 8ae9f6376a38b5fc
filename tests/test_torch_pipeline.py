"""Config-driven training and the sweep in the port against the JAX package:
``training_pipeline.build_model`` (both mappers, a task prompt, unfrozen
GPT-2) on JAX GPT-2 weights carried across, one epoch of ``run``, a sweep
``run_one`` with its test pass, ``select_test_checkpoint``, RAT configs
(``run`` on every store backend and a RAT ``run_one``, on the JAX
package's weights) and the refusal of meshes this process cannot run (a dp
the world size does not match, tensor parallelism)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from gpt2_image_captioning_tpu import sweep as jsweep
from gpt2_image_captioning_tpu import training_pipeline as jtp
from gpt2_image_captioning_tpu.core.config import Config as JConfig
from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu_torch import sweep as tsweep
from gpt2_image_captioning_tpu_torch import training_pipeline as ttp
from gpt2_image_captioning_tpu_torch.core.config import Config, load_config
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32
from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import porting

from helpers import make_synthetic_coco, tiny_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTOK = tiny_tokenizer()
TTOK = GPT2BPETokenizer(JTOK.encoder, sorted(JTOK.bpe_ranks, key=JTOK.bpe_ranks.get))
GPT = dict(vocab_size=len(JTOK.encoder), n_positions=32, n_embd=32, n_layer=1, n_head=2)


def base_config(root) -> dict:
    """config.yml's schema at a CPU size, on one device, in float32."""
    return {
        "seed": 0,
        "max_caption_length": 10,
        "vision_encoder": "clip",
        "retrieval_augmentation": False,
        "paths": {
            "data_dir": str(root) + "/",
            "embeddings_path": "${paths.data_dir}embeddings/",
            "annotations_path": "${paths.data_dir}annotations/",
            "checkpoints_path": "${paths.data_dir}checkpoints/",
            "vector_db_path": str(root / "db") + "/",
        },
        "mapping": {"type": "mlp", "embed_dim": 16, "gpt_dim": 32, "prefix_length": 2,
                    "hidden_length": 2},
        "image_captioning": {"freeze_gpt_weights": True, "prefix_task_prompt": None},
        "retrieval": {"top_k": 3, "top_i": 2, "aggregation_type": "mean", "embed_dim": 16},
        "training": {"batch_size": 8, "num_epochs": 1, "num_workers": 0, "learning_rate": 1e-3,
                     "num_warmup_steps": 0, "save_every_epoch": 1},
        "validation": {"eval_every_epoch": 1, "batch_size": 8, "temperature": 0.0,
                       "top_p": 1.0},
        "tpu": {"mesh": {"dp": 1, "tp": 1}, "compute_dtype": "float32", "grad_accum_steps": 1},
    }


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """train / val / test splits under the pipeline's file names."""
    root = tmp_path_factory.mktemp("pipeline")
    (root / "embeddings").mkdir()
    (root / "annotations").mkdir()
    for split, n, ann in (("train", 10, "captions_train2017.json"),
                          ("val", 6, "captions_val2017.json"),
                          ("test", 6, "captions_val2014.json")):
        e, a, _ = make_synthetic_coco(root, n_images=n, captions_per_image=2, prefix=split,
                                      fmt="pt")
        os.rename(e, root / "embeddings" / f"{split}_clip_embeddings.pt")
        os.rename(a, root / "annotations" / ann)
    # the train split's caption embeddings, the RAT store's: 1-3 vectors an image
    names = torch.load(root / "embeddings" / "train_clip_embeddings.pt")["filenames"]
    rng = np.random.default_rng(9)
    torch.save([{"filenames": f, "embeddings": [
        {"caption_id": 10 * i + c, "embedding": torch.from_numpy(
            rng.normal(size=16).astype(np.float32))} for c in range(1 + i % 3)]}
        for i, f in enumerate(names)], root / "embeddings" / "train_clip_caption_embeddings.pt")
    return root


@pytest.fixture
def tiny_pipelines(monkeypatch):
    """Both packages' pipeline and sweep with the tiny tokenizer and a tiny
    GPT-2 (the real ones need the downloaded assets and 124M weights)."""
    for mod, tok in ((jtp, JTOK), (jsweep, JTOK), (ttp, TTOK), (tsweep, TTOK)):
        monkeypatch.setattr(mod, "load_gpt2_tokenizer", lambda *a, tok=tok, **k: tok)
    for mod, sweep, gcfg in ((jtp, jsweep, JG.GPT2Config(**GPT)),
                             (ttp, tsweep, TG.GPT2Config(**GPT))):
        build = mod.build_model
        tiny = (lambda cfg, tokenizer, build=build, gcfg=gcfg, **kw:
                build(cfg, tokenizer, gpt_config=gcfg, **kw))
        monkeypatch.setattr(mod, "build_model", tiny)
        monkeypatch.setattr(sweep, "build_model", tiny)


@pytest.fixture
def same_weights(monkeypatch, tiny_pipelines):
    """The port's ``build_model`` (in the pipeline and the sweep) carrying
    over the weights the JAX package's tiny ``build_model`` draws for the
    same config, so that runs can be compared value for value."""
    jbuild, tbuild = jtp.build_model, ttp.build_model

    def build(cfg, tokenizer, **kw):
        model = tbuild(cfg, tokenizer, **kw)
        j = jbuild(JConfig(cfg.to_dict()), JTOK)
        model.trainable, model.frozen = porting.from_jax_numpy(
            *jax.tree.map(np.asarray, (j.trainable, j.frozen)), model.cfg,
            device=kw.get("device", "cuda"))
        return model

    monkeypatch.setattr(ttp, "build_model", build)
    monkeypatch.setattr(tsweep, "build_model", build)


def _listing(root) -> list[str]:
    """The files under ``root``; TensorBoard's event files are named by the
    clock and the process, so they are listed by their prefix."""
    names = (os.path.relpath(os.path.join(d, f), root) for d, _, files in os.walk(root)
             for f in files)
    return sorted(n.split("events.out.tfevents")[0] + "events.out.tfevents" if
                  "events.out.tfevents" in n else n for n in names)


BUILDS = {
    "mlp": {},
    "transformer": {"mapping": {"type": "transformer"}},
    "prompt": {"image_captioning": {"prefix_task_prompt": "the cat"}},
    "unfrozen_prompt": {"mapping": {"type": "transformer"},
                        "image_captioning": {"freeze_gpt_weights": False,
                                             "prefix_task_prompt": "a dog"}},
}


@pytest.mark.parametrize("case", sorted(BUILDS))
def test_build_model_matches_jax(case, tmp_path):
    """The two packages' ``build_model`` of one config on the same JAX GPT-2
    weights: the same configuration, task prefix (from the given wte) and
    trees; with the JAX mapper carried across, the same loss within 1e-5."""
    from gpt2_image_captioning_tpu_torch.core.config import update_cfg

    cfg = update_cfg(Config(base_config(tmp_path)), BUILDS[case])
    jgpt = JG.init(jax.random.PRNGKey(3), JG.GPT2Config(**GPT))
    jmodel = jtp.build_model(JConfig(cfg.to_dict()), JTOK, gpt_params=jgpt,
                             gpt_config=JG.GPT2Config(**GPT))
    tgpt = porting.from_jax_numpy(
        {}, {"gpt": jax.tree.map(np.asarray, jgpt)}, jmodel.cfg, device="cpu")[1]["gpt"]
    tmodel = ttp.build_model(cfg, TTOK, gpt_params=tgpt, gpt_config=TG.GPT2Config(**GPT),
                             device="cpu")
    assert tmodel.policy == F32 and jmodel.policy == JF32
    assert tmodel.cfg.task_prompt_ids == jmodel.cfg.task_prompt_ids
    assert tmodel.cfg.freeze_gpt_weights == jmodel.cfg.freeze_gpt_weights
    assert tmodel.cfg.mapping.type == jmodel.cfg.mapping.type
    assert sorted(tmodel.trainable) == sorted(jmodel.trainable)
    assert sorted(tmodel.frozen) == sorted(jmodel.frozen)
    if "task_prefix" in jmodel.trainable:
        np.testing.assert_array_equal(tmodel.trainable["task_prefix"].numpy(),
                                      np.asarray(jmodel.trainable["task_prefix"]))
    tmodel.trainable, tmodel.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (jmodel.trainable, jmodel.frozen)), tmodel.cfg, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, GPT["vocab_size"] - 1, size=(3, 6)).astype(np.int32)
    emb = rng.normal(size=(3, 16)).astype(np.float32)
    want = float(jmodel.forward(caption_token_ids=ids, image_embeddings=emb))
    got = float(tmodel.forward(caption_token_ids=ids, image_embeddings=emb))
    assert abs(got - want) <= 1e-5


def test_build_model_policy_and_seed(tmp_path):
    cfg = Config(base_config(tmp_path))
    cfg.tpu = {**cfg.tpu.to_dict(), "compute_dtype": "bfloat16", "remat": True}
    a = ttp.build_model(cfg, TTOK, gpt_config=TG.GPT2Config(**GPT), device="cpu")
    b = ttp.build_model(cfg, TTOK, gpt_config=TG.GPT2Config(**GPT), device="cpu")
    assert a.policy == BF16 and a.cfg.remat
    torch.testing.assert_close(a.trainable, b.trainable, rtol=0, atol=0)  # seeded by cfg.seed


def test_run_one_epoch_matches_jax(data, tmp_path, monkeypatch, tiny_pipelines):
    """One epoch of ``run``: the history's keys, the losses' count and the
    artifacts' names are the JAX package's."""
    cfg = Config(base_config(data))
    out = {}
    for name, mod, c in (("jax", jtp, JConfig(cfg.to_dict())), ("port", ttp, cfg)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)  # train() logs under ./logs
        kw = {"device": "cpu"} if name == "port" else {}
        hist = mod.run(c, save_dir=str(tmp_path / name / "ckpt"), **kw)
        out[name] = (hist, _listing(tmp_path / name))
    (jh, jfiles), (th, tfiles) = out["jax"], out["port"]
    assert sorted(th) == sorted(jh)
    assert len(th["epoch_losses"]) == len(jh["epoch_losses"]) == 1
    assert [sorted(m) for m in th["val_metrics"]] == [sorted(m) for m in jh["val_metrics"]]
    assert tfiles == jfiles
    assert "ckpt/model_epoch_1.npz" in tfiles and "ckpt/eval_results/epoch_1_val_metrics.json" \
        in tfiles


def test_sweep_run_one_matches_jax(data, tmp_path, monkeypatch, tiny_pipelines):
    """``run_one``: the same files under ``checkpoint_<id>/``, the same
    ``training_info`` fields and ``test_metrics`` keys, the test predictions
    of the checkpoint ``select_test_checkpoint`` picks."""
    auto = {"model": {"7": {"description": "tiny transformer run",
                            "mapping": {"type": "transformer"}}}}
    (tmp_path / "automation.yml").write_text(yaml.safe_dump(auto))
    (tmp_path / "config.yml").write_text(yaml.safe_dump(base_config(data)))
    plans = tsweep.plan_runs(load_config(str(tmp_path / "config.yml")),
                             load_config(str(tmp_path / "automation.yml")))
    assert [(i, d) for i, _, d in plans] == [("7", "tiny transformer run")]
    _, cfg, desc = plans[0]
    runs = {}
    for name, mod, c in (("jax", jsweep, JConfig(cfg.to_dict())), ("port", tsweep, cfg)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        kw = {"device": "cpu"} if name == "port" else {}
        mod.run_one(c, "7", str(tmp_path / name / "sweep"), desc, **kw)
        runs[name] = tmp_path / name / "sweep" / "checkpoint_7"
    assert _listing(runs["port"]) == _listing(runs["jax"])
    fields = {n: [ln.split(":")[0] for ln in (r / "training_info_7.txt").read_text().splitlines()]
              for n, r in runs.items()}
    assert fields["port"] == fields["jax"]
    info = (runs["port"] / "training_info_7.txt").read_text()
    assert "description: tiny transformer run" in info
    metrics = {n: json.loads((r / "test_metrics_7.json").read_text()) for n, r in runs.items()}
    assert sorted(metrics["port"]) == sorted(metrics["jax"])
    preds = json.loads((runs["port"] / "test_predictions_7.json").read_text())
    assert [set(p) for p in preds] == [{"image_id", "caption"}] * 6
    assert load_config(str(runs["port"] / "config_7.yml")) == cfg


CHECKPOINT_LISTS = [
    ["best_model_epoch_1.npz", "best_model_epoch_3.npz", "best_model_epoch_10.npz",
     "model_epoch_1.npz", "model_epoch_10.npz", "config_1.yml"],
    ["model_epoch_2.npz", "model_epoch_10.npz"],
    ["best_model_epoch_2.pt"],
    ["config_1.yml"],
    [],
    ["model_epoch_3.pt", "best_model_epoch_1.npz", "optimizer_epoch_3.npz"],
    ["model_epoch_12.npz", "model_epoch_9.npz", "model_epoch_x.npz", "my_model_epoch_99.npz"],
]


@pytest.mark.parametrize("files", CHECKPOINT_LISTS, ids=range(len(CHECKPOINT_LISTS)))
def test_select_test_checkpoint_matches_jax(files):
    assert tsweep.select_test_checkpoint(files) == jsweep.select_test_checkpoint(files)


RAT = {"retrieval_augmentation": True,
       "retrieval": {"top_k": 4, "top_i": 2, "aggregation_type": "mean", "embed_dim": 16}}


def _rat_run(data, tmp_path, monkeypatch, name, mod, cfg, **kw):
    (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / name)
    hist = mod.run(cfg, save_dir=str(tmp_path / name / "ckpt"), **kw)
    return hist, _listing(tmp_path / name)


@pytest.mark.parametrize("backend", ["device", "flat", "hnsw", "persistent"])
def test_rat_run_matches_jax(backend, data, tmp_path, monkeypatch, same_weights):
    """``run`` with ``retrieval_augmentation: true`` on each store backend:
    the device and flat stores give the JAX package's losses, validation
    metrics and files (the ``_rat`` evaluation artifacts); the HNSW and
    persistent stores, exact at this size, give the flat store's losses."""
    from gpt2_image_captioning_tpu_torch.core.config import update_cfg

    cfg = update_cfg(Config(base_config(data)), {**RAT, "retrieval": {
        **RAT["retrieval"], "backend": backend}})
    th, tfiles = _rat_run(data, tmp_path, monkeypatch, "port", ttp, cfg, device="cpu")
    assert "ckpt/eval_results/epoch_1_val_predictions_rat.json" in tfiles
    assert len(th["epoch_losses"]) == 1 and np.isfinite(th["epoch_losses"][0])
    if backend in ("device", "flat"):
        jh, jfiles = _rat_run(data, tmp_path, monkeypatch, "jax", jtp, JConfig(cfg.to_dict()))
        np.testing.assert_allclose(th["epoch_losses"], jh["epoch_losses"], rtol=1e-5)
        assert len(th["val_metrics"]) == len(jh["val_metrics"]) == 1
        assert th["val_metrics"][0] == pytest.approx(jh["val_metrics"][0], rel=1e-5)
        assert tfiles == jfiles
        preds = "ckpt/eval_results/epoch_1_val_predictions_rat.json"
        assert json.loads((tmp_path / "port" / preds).read_text()) == \
            json.loads((tmp_path / "jax" / preds).read_text())
    else:
        flat = update_cfg(cfg, {"retrieval": {"backend": "flat"}})
        fh, _ = _rat_run(data, tmp_path, monkeypatch, "flat", ttp, flat, device="cpu")
        np.testing.assert_allclose(th["epoch_losses"], fh["epoch_losses"], rtol=1e-6)
    if backend == "persistent":
        assert os.path.exists(os.path.join(cfg.paths.vector_db_path, "persistent_meta.json"))


def test_sweep_run_one_rat_matches_jax(data, tmp_path, monkeypatch, same_weights):
    """``run_one`` of a RAT id (18's overrides at a CPU size): the JAX
    package's files, and its test predictions through the rebuilt store."""
    from gpt2_image_captioning_tpu_torch.core.config import update_cfg

    cfg = update_cfg(Config(base_config(data)), {**RAT, "mapping": {"type": "transformer"}})
    runs = {}
    for name, mod, c in (("jax", jsweep, JConfig(cfg.to_dict())), ("port", tsweep, cfg)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        kw = {"device": "cpu"} if name == "port" else {}
        mod.run_one(c, "18", str(tmp_path / name / "sweep"), "tiny RAT run", **kw)
        runs[name] = tmp_path / name / "sweep" / "checkpoint_18"
    assert _listing(runs["port"]) == _listing(runs["jax"])
    assert json.loads((runs["port"] / "test_predictions_18.json").read_text()) == \
        json.loads((runs["jax"] / "test_predictions_18.json").read_text())
    info = (runs["port"] / "training_info_18.txt").read_text()
    assert info.split("training duration")[0] == \
        (runs["jax"] / "training_info_18.txt").read_text().split("training duration")[0]


REFUSED = {
    "dp2": ({"tpu": {"mesh": {"dp": 2, "tp": 1}}}, ValueError, r"mesh 2x1 != 1 devices"),
    "dp8": ({"tpu": {"mesh": {"dp": 8}}}, ValueError, r"mesh 8x1 != 1 devices"),
    "tp2": ({"tpu": {"mesh": {"dp": 1, "tp": 2}}}, ValueError,
            r"tp=2 does not divide device count 1"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_configs_refused_before_any_read(case, tmp_path):
    """Without a process group a dp above 1 raises ``MeshSpec.resolve``'s
    error, as does tp 2, before
    any data is read (the paths hold nothing) or any directory is made."""
    from gpt2_image_captioning_tpu_torch.core.config import update_cfg

    updates, error, item = REFUSED[case]
    cfg = update_cfg(Config(base_config(tmp_path / "absent")), updates)
    with pytest.raises(error, match=item):
        ttp.run(cfg, device="cpu")
    with pytest.raises(error, match=item):
        tsweep.run_one(cfg, "1", str(tmp_path / "out"), device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("dp", [-1, 1])
def test_one_device_meshes_accepted(dp, tmp_path):
    cfg = Config(base_config(tmp_path))
    cfg.tpu = {"mesh": {"dp": dp, "tp": 1}}
    ttp.refuse_unported(cfg)
    raw = base_config(tmp_path)
    raw.pop("tpu")  # a config without the tpu block runs on one device
    ttp.refuse_unported(Config(raw))


def test_sweep_plans_rat_ids(capsys, tmp_path):
    """The repo's automation_config.yml: ids 18 and 19 (RAT) plan with the
    rest — top_k 20, top_i 6, mean; 19 with GPT-2 unfrozen — and a mesh
    id is still refused up front, by ``main`` too."""
    base = load_config(os.path.join(REPO, "config.yml"))
    auto = load_config(os.path.join(REPO, "automation_config.yml"))
    plans = {i: c for i, c, _ in tsweep.plan_runs(base, auto)}
    assert sorted(plans, key=int) == ["1", "2", "18", "19"]
    for i in ("18", "19"):
        assert plans[i].retrieval_augmentation is True
        assert (plans[i].retrieval.top_k, plans[i].retrieval.top_i,
                plans[i].retrieval.aggregation_type) == (20, 6, "mean")
        assert plans[i].image_captioning.freeze_gpt_weights == (i == "18")
    assert [i for i, _, _ in tsweep.plan_runs(base, auto, ["1", "2"])] == ["1", "2"]
    (tmp_path / "auto.yml").write_text(yaml.safe_dump(
        {"model": {"5": {"tpu": {"mesh": {"dp": 2}}}, "18": {"retrieval_augmentation": True}}}))
    with pytest.raises(SystemExit) as e:
        tsweep.main(["--config", os.path.join(REPO, "config.yml"),
                     "--automation", str(tmp_path / "auto.yml")])
    assert e.value.code == 2 and "['5']" in capsys.readouterr().err
