"""The port's ``train()`` against the JAX package's on a one-device CPU mesh,
in float32, on the same synthetic COCO and the same initial weights
(GPT-2 1 x 32 frozen over the tiny tokenizer's ids, the MLP mapper
trainable — the transformer mapper's attention key bias has an exactly-zero
gradient whose float32 noise Adam amplifies, see ``test_torch_train.py``):

- two epochs with evaluation each epoch: epoch losses to rtol 1e-5, trained
  leaves to atol 1e-5, equal greedy predictions and metrics, the same
  artifact files with the same keys;
- accumulation 2 with a partial trailing group, and the learning rate of
  every step equal to the JAX schedule's (micro-batches x epochs: trap 5 of
  ROADMAP.md);
- resume: one epoch and a resumed second equal two straight in the port; a
  JAX run stopped after epoch 1 and resumed by the port — and the other way
  round — equal the straight run (the optimizer state crosses); resuming a
  finished run does nothing;
- ``profile_dir`` writes a ``torch.profiler`` trace, ``remat`` leaves the
  losses as they are, and the unported options raise;
- RAT (``rat_cfg`` with a device or a flat store): the JAX package's losses
  and trained leaves.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.mesh import MeshSpec, create_mesh
from gpt2_image_captioning_tpu.data.dataset import CocoDataset as JCoco
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.train import loop as JL
from gpt2_image_captioning_tpu.train import optim as JO
from gpt2_image_captioning_tpu_torch.core.mesh import Mesh
from gpt2_image_captioning_tpu_torch.core.mesh import create_mesh as create_port_mesh
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.data.dataset import CocoDataset as TCoco
from gpt2_image_captioning_tpu_torch.data.tokenizer import GPT2BPETokenizer
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.train import loop as TL

from helpers import make_synthetic_coco, tiny_tokenizer

TRAIN = dict(batch_size=8, learning_rate=1e-3, save_every_epoch=1)  # 24 captions: 3 steps
EVAL = dict(eval_batch_size=4, eval_max_length=8)  # 5 val images: the last batch padded
# a tp mesh built by hand, without its process groups, which the port refuses
TP2 = Mesh(dp=1, tp=2, rank=0, world_size=1, group=None, backend=None,
           device=torch.device("cpu"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("epoch")
    jtok = tiny_tokenizer()
    ttok = GPT2BPETokenizer(jtok.encoder, sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get))
    train_files = make_synthetic_coco(root, n_images=8, captions_per_image=3, prefix="train")
    val_files = make_synthetic_coco(root, n_images=5, captions_per_image=2, prefix="val", seed=1)
    gkw = dict(vocab_size=jtok.vocab_size, n_positions=64, n_embd=32, n_layer=1, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=16, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=jtok.eos_token_id)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=jtok.eos_token_id)
    return {
        "root": root, "jcfg": jcfg, "tcfg": tcfg, "jtok": jtok, "ttok": ttok,
        "jtrain": JCoco(*train_files[:2], tokenizer=jtok, max_length=10),
        "ttrain": TCoco(*train_files[:2], tokenizer=ttok, max_length=10),
        "jval": JCoco(*val_files[:2], tokenizer=jtok, max_length=10),
        "tval": TCoco(*val_files[:2], tokenizer=ttok, max_length=10),
        "val_ann": val_files[1],
        "mesh": create_mesh(MeshSpec(dp=1, tp=1), devices=jax.devices()[:1]),
    }


def jax_model(s, seed=0):
    return JC.ImageCaptioningModel(s["jcfg"], tokenizer=s["jtok"], rng=jax.random.PRNGKey(seed))


def port_model(s, seed=0):
    """The port's façade over the initial weights of :func:`jax_model`."""
    m = TC.ImageCaptioningModel(s["tcfg"], tokenizer=s["ttok"], device="cpu")
    j = jax_model(s, seed)
    m.trainable, m.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (j.trainable, j.frozen)), s["tcfg"], device="cpu")
    return m


def fresh(model, other):
    """``model`` (the run's frozen GPT-2) with the trainable tree of
    ``other``: a resume must restore every trainable leaf."""
    model.trainable = other.trainable
    return model


def jax_train(s, name, model=None, **kw):
    model = model or jax_model(s)
    out = str(s["root"] / name)
    hist = JL.train(s["jtrain"], model, outputs_dir=out, log_dir=os.path.join(out, "logs"),
                    mesh=s["mesh"], **{**TRAIN, **kw})
    return model, hist, out


def port_train(s, name, model=None, **kw):
    model = model or port_model(s)
    out = str(s["root"] / name)
    hist = TL.train(s["ttrain"], model, outputs_dir=out, log_dir=os.path.join(out, "logs"),
                    device="cpu", **{**TRAIN, **kw})
    return model, hist, out


def assert_leaves_close(got, want, atol):
    got = {k: v.detach().numpy() for k, v in flatten_with_paths(got).items()}
    want = {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         want)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def tree_files(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if not n.startswith("events.out.tfevents"))


@pytest.fixture(scope="module")
def straight(setup):
    """Two epochs with validation each epoch, in both packages."""
    kw = dict(num_epochs=2, val_annotations_path=setup["val_ann"], **EVAL)
    jm, jhist, jout = jax_train(setup, "jax_straight", val_dataset=setup["jval"], **kw)
    tm, thist, tout = port_train(setup, "port_straight", val_dataset=setup["tval"], **kw)
    return jm, jhist, jout, tm, thist, tout


def test_train_matches_jax(straight):
    jm, jhist, jout, tm, thist, tout = straight
    np.testing.assert_allclose(thist["epoch_losses"], jhist["epoch_losses"], rtol=1e-5)
    assert thist["epoch_losses"][1] < thist["epoch_losses"][0]
    assert_leaves_close(tm.trainable, jm.trainable, atol=1e-5)
    assert sorted(thist) == sorted(jhist)
    assert thist["best_epoch"] == jhist["best_epoch"]
    assert thist["best_val_cider"] == pytest.approx(jhist["best_val_cider"], rel=1e-12, abs=0)
    assert len(thist["val_metrics"]) == len(jhist["val_metrics"]) == 2
    for got, want in zip(thist["val_metrics"], jhist["val_metrics"]):
        assert sorted(got) == sorted(want)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert {k: v for k, v in got.items() if k != "loss"} == pytest.approx(
            {k: v for k, v in want.items() if k != "loss"}, rel=1e-12, abs=0)
    assert thist["step_timing"]["steps"] == jhist["step_timing"]["steps"] == 6


def test_artifacts_match_jax(straight):
    jm, jhist, jout, tm, thist, tout = straight
    files = tree_files(tout)
    assert files == tree_files(jout)
    best = jhist["best_epoch"]
    assert {"model_epoch_1.npz", "model_epoch_2.npz", "optimizer_epoch_1.npz",
            "optimizer_epoch_2.npz", f"best_model_epoch_{best}.npz", "loss_curve.png",
            "logs/metrics.jsonl", "eval_results/epoch_1_val_predictions.json",
            "eval_results/epoch_2_val_metrics.json", "eval_results/val_metrics_summary.json",
            "eval_results/val_metrics_curve.png"} <= set(files)
    for name in files:
        got, want = os.path.join(tout, name), os.path.join(jout, name)
        if name.endswith(".npz"):
            with np.load(got) as g, np.load(want) as w:
                assert sorted(g.files) == sorted(w.files), name
                for k in w.files:
                    assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (name, k)
                    np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-4,
                                               err_msg=f"{name}: {k}")
        elif name.endswith("predictions.json"):
            assert json.load(open(got)) == json.load(open(want)), name
        elif name.endswith(".json"):
            g, w = json.load(open(got)), json.load(open(want))
            assert type(g) is type(w) and len(g) == len(w), name
            for a, b in zip(g if isinstance(g, list) else [g], w if isinstance(w, list) else [w]):
                assert sorted(a) == sorted(b), name
                assert a == pytest.approx(b, rel=1e-5), name
    with np.load(os.path.join(tout, "optimizer_epoch_2.npz")) as g:
        assert g["step"].dtype == np.int32 and int(g["step"]) == 6
    rows = [json.loads(line) for line in open(os.path.join(tout, "logs/metrics.jsonl"))]
    want = [json.loads(line) for line in open(os.path.join(jout, "logs/metrics.jsonl"))]
    assert [(r["tag"], r["step"]) for r in rows] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in rows], [r["value"] for r in want], rtol=1e-5)


def test_accumulation_and_schedule_match_jax(setup, monkeypatch):
    """Micro-batches of 5 (five an epoch, the last padded), accumulation 2:
    two full groups and a trailing group of one real micro-batch and one
    all-ignored pad; 2 warm-up steps.  The LR of each port step equals the
    JAX schedule over steps_per_epoch x num_epochs = 10 steps (not the 6
    optimizer steps)."""
    seen = {}
    real_jax_step = JL.make_train_step

    def jax_step(cfg, opt_cfg, *a, **k):
        seen["opt_cfg"] = opt_cfg
        return real_jax_step(cfg, opt_cfg, *a, **k)

    monkeypatch.setattr(JL, "make_train_step", jax_step)
    real_port_step = TL.make_train_step
    lrs = []

    def port_step(*a, **k):
        step = real_port_step(*a, **k)

        def wrapped(trainable, optimizer, scheduler, frozen, batch):
            lrs.append(optimizer.param_groups[0]["lr"])
            return step(trainable, optimizer, scheduler, frozen, batch)

        return wrapped

    monkeypatch.setattr(TL, "make_train_step", port_step)
    kw = dict(num_epochs=2, batch_size=5, grad_accum_steps=2, num_warmup_steps=2)
    jm, jhist, _ = jax_train(setup, "jax_accum", **kw)
    tm, thist, _ = port_train(setup, "port_accum", **kw)
    np.testing.assert_allclose(thist["epoch_losses"], jhist["epoch_losses"], rtol=1e-5)
    assert_leaves_close(tm.trainable, jm.trainable, atol=1e-5)
    opt_cfg = seen["opt_cfg"]
    assert opt_cfg.num_training_steps == 10 and len(lrs) == 6
    want = [1e-3 * float(JO.linear_warmup_schedule(opt_cfg, jax.numpy.asarray(s)))
            for s in range(6)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert lrs[0] == 0.0 and lrs[2] == pytest.approx(1e-3 * 8 / 8)


def test_resume_in_the_port_matches_the_straight_run(setup, straight):
    tm = straight[3]
    port_train(setup, "port_resume", num_epochs=2, stop_after_epochs=1)
    out = str(setup["root"] / "port_resume")
    assert os.path.exists(os.path.join(out, "optimizer_epoch_1.npz"))
    assert not os.path.exists(os.path.join(out, "model_epoch_2.npz"))
    model = fresh(port_model(setup), port_model(setup, seed=5))
    _, hist, _ = port_train(setup, "port_resume", model=model, num_epochs=2, resume=True)
    assert len(hist["epoch_losses"]) == 1
    np.testing.assert_allclose(hist["epoch_losses"], straight[4]["epoch_losses"][1:], rtol=1e-6)
    assert_leaves_close(model.trainable, jax.tree.map(lambda t: t.detach().numpy(),
                                                      tm.trainable), atol=1e-6)


def test_port_resumes_a_jax_run(setup, straight):
    """JAX trains epoch 1 and stops; the port resumes from its
    ``model_epoch_1.npz`` and ``optimizer_epoch_1.npz``."""
    jm, jhist = straight[0], straight[1]
    _, _, out = jax_train(setup, "jax_then_port", num_epochs=2, stop_after_epochs=1)
    model = fresh(port_model(setup), port_model(setup, seed=5))
    _, hist, _ = port_train(setup, "jax_then_port", model=model, num_epochs=2, resume=True)
    np.testing.assert_allclose(hist["epoch_losses"], jhist["epoch_losses"][1:], rtol=1e-5)
    assert_leaves_close(model.trainable, jm.trainable, atol=1e-5)


def test_jax_resumes_a_port_run(setup, straight):
    jm = straight[0]
    port_train(setup, "port_then_jax", num_epochs=2, stop_after_epochs=1)
    model = fresh(jax_model(setup), jax_model(setup, seed=5))
    _, hist, _ = jax_train(setup, "port_then_jax", model=model, num_epochs=2, resume=True)
    np.testing.assert_allclose(hist["epoch_losses"], straight[1]["epoch_losses"][1:], rtol=1e-5)
    assert_leaves_close(porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (model.trainable, model.frozen)), setup["tcfg"],
        device="cpu")[0], jm.trainable, atol=1e-5)


def test_resuming_a_finished_run_does_nothing(setup, straight):
    tm, thist, tout = straight[3:]
    before = {k: v.clone() for k, v in flatten_with_paths(tm.trainable).items()}
    hist = TL.train(setup["ttrain"], tm, num_epochs=2, outputs_dir=tout, resume=True,
                    log_dir=os.path.join(tout, "logs_again"), device="cpu", **TRAIN)
    assert hist["epoch_losses"] == [] and hist["val_metrics"] == []
    assert hist["step_timing"] == {"steps": 0}
    for k, v in flatten_with_paths(tm.trainable).items():
        assert torch.equal(v, before[k]), k


def test_profile_dir_writes_a_trace_and_remat_keeps_the_losses(setup):
    trace_dir = str(setup["root"] / "trace")
    _, hist, out = port_train(setup, "port_profiled", num_epochs=1, profile_dir=trace_dir)
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.load(open(os.path.join(trace_dir, traces[0])))["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    _, remat, _ = port_train(setup, "port_remat", num_epochs=1, remat=True)
    assert remat["epoch_losses"] == hist["epoch_losses"]


@pytest.mark.parametrize("option, error", [
    (dict(mesh=TP2), ValueError), (dict(val_dataset=object()), ValueError)])
def test_unported_options_raise(setup, option, error):
    with pytest.raises(error):
        TL.train(setup["ttrain"], port_model(setup), num_epochs=1, device="cpu",
                 outputs_dir=str(setup["root"] / "refused"), **option, **TRAIN)


def test_one_rank_mesh_trains_as_no_mesh(setup):
    """``train()`` on a one-rank mesh (two epochs with evaluation): the
    epoch losses, metrics and trained leaves of the run without a mesh, bit
    for bit, and the same files."""
    kw = dict(num_epochs=2, val_dataset=setup["tval"], val_annotations_path=setup["val_ann"],
              **EVAL)
    plain, hist, out = port_train(setup, "no_mesh", **kw)
    meshed, mhist, mout = port_train(setup, "one_rank_mesh", mesh=create_port_mesh(device="cpu"), **kw)
    assert mhist["epoch_losses"] == hist["epoch_losses"]
    assert mhist["val_metrics"] == hist["val_metrics"]
    for k, v in flatten_with_paths(plain.trainable).items():
        assert torch.equal(flatten_with_paths(meshed.trainable)[k], v), k
    assert sorted(os.listdir(mout)) == sorted(os.listdir(out))


@pytest.mark.parametrize("backend", ["device", "flat"])
def test_rat_options_train_and_match_jax(setup, backend):
    """``train(rat_cfg=, db_store=)`` — the fused device store or the flat
    host store, the mean aggregator, a store of 1-4 caption vectors an
    image over the train images — gives the JAX package's epoch losses and
    trained leaves; either option alone raises."""
    from gpt2_image_captioning_tpu.models import rat as JR
    from gpt2_image_captioning_tpu.retrieval import exact as JEx
    from gpt2_image_captioning_tpu.retrieval import store as JS
    from gpt2_image_captioning_tpu_torch.models import rat as TR
    from gpt2_image_captioning_tpu_torch.retrieval import exact as TEx
    from gpt2_image_captioning_tpu_torch.retrieval import store as TS

    names, img = setup["ttrain"].image_filenames, setup["ttrain"].image_embeddings
    rng = np.random.default_rng(8)
    entries = [{"filenames": f, "embeddings": [
        {"caption_id": 10 * i + c, "embedding": torch.from_numpy(rng.normal(size=16)
                                                                  .astype(np.float32))}
        for c in range(1 + i % 4)]} for i, f in enumerate(names)]
    if backend == "device":
        jstore = JEx.DeviceVectorStore.build(names, img, entries)
        tstore = TEx.DeviceVectorStore.build(names, img, entries, device="cpu")
    else:
        jstore = JS.create_store(names, img, entries, backend="flat")
        tstore = TS.create_store(names, img, entries, backend="flat")
    jm, tm = jax_model(setup), port_model(setup)
    jrcfg, trcfg = JR.RATConfig(embed_dim=16, top_k=5, top_i=3), TR.RATConfig(16, top_k=5, top_i=3)
    _, jh, _ = jax_train(setup, f"jax_rat_{backend}", jm, num_epochs=2, rat_cfg=jrcfg,
                         db_store=jstore)
    _, th, _ = port_train(setup, f"port_rat_{backend}", tm, num_epochs=2, rat_cfg=trcfg,
                          db_store=tstore)
    np.testing.assert_allclose(th["epoch_losses"], jh["epoch_losses"], rtol=1e-5)
    assert_leaves_close(tm.trainable, jm.trainable, 1e-5)
    _, plain, _ = port_train(setup, f"port_plain_{backend}", num_epochs=1)
    assert plain["epoch_losses"][0] != th["epoch_losses"][0]
    for option in (dict(rat_cfg=trcfg), dict(db_store=tstore)):
        with pytest.raises(ValueError, match="together"):
            port_train(setup, "refused", num_epochs=1, **option)


def test_num_workers_is_accepted(setup):
    _, hist, _ = port_train(setup, "port_workers", num_epochs=1, num_workers=7,
                            save_every_epoch=0, checkpoint_format="pt")
    assert len(hist["epoch_losses"]) == 1
    assert os.path.exists(str(setup["root"] / "port_workers" / "model_epoch_1.pt"))
    m = port_model(setup)
    m.load_saved_parameters(str(setup["root"] / "port_workers" / "model_epoch_1.pt"))
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(setup["tcfg"])


def test_training_renews_the_decode_caches(setup):
    """The train step changes the trainable tensors in place, so the
    façade's bf16 copy and packs, cached on the trees' identity, would keep
    the old weights: ``train()`` drops them after each epoch."""
    model = port_model(setup)
    stale = model.decode_pack("bf16")
    port_train(setup, "port_caches", model=model, num_epochs=1, save_every_epoch=0)
    tr, _, _, packed, _ = model.decode_pack("bf16")
    assert tr is not stale[0] and packed is not stale[3]
    live = flatten_with_paths(model.trainable)
    old = flatten_with_paths(stale[0])
    for k, v in flatten_with_paths(tr).items():
        assert torch.equal(v, live[k].detach().to(torch.bfloat16)), k
    assert any(not torch.equal(v, old[k]) for k, v in flatten_with_paths(tr).items())
