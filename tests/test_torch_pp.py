"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's, at ``tests/test_pipeline.py``'s configs (GPT-2 4 or 2 x 32 with
4 heads over 211 ids, the MLP mapper, a padded batch tail), meshes and
tolerances, the JAX side on the conftest's virtual 8-device mesh.

One launch of four gloo ranks (``tests/torch_dist_worker.py``, task ``pp``)
runs pp 4 with GPT-2 unfrozen and frozen; one of eight runs dp × pp (4, 2)
with 1 and 2 microbatches and the train step on (2, 4):

- loss and gradients against the JAX pipeline's on the same mesh: loss
  atol / rtol 1e-5, gradients atol 2e-5 (rtol 1e-5), on every rank;
- two pipeline AdamW steps: each step's loss atol / rtol 1e-5, the
  parameters atol 3e-5;
- the indivisible-layers, microbatch and mesh-size errors word for word.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.parallel import pipeline as JPP
from gpt2_image_captioning_tpu.train import optim as JO
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.parallel import pipeline as TPP

from torch_dist_worker import launch

MKW = dict(prefix_length=3, embed_dim=16, gpt_dim=32)


def _gkw(n_layer):
    return dict(vocab_size=211, n_positions=64, n_embd=32, n_layer=n_layer, n_head=4)


def _cfg(freeze=False, n_layer=4):
    """``test_pipeline.py::_cfg``."""
    return JC.CaptionerConfig(gpt2=JG.GPT2Config(**_gkw(n_layer)),
                              mapping=JM.MLPMappingConfig(**MKW), eos_token_id=210,
                              freeze_gpt_weights=freeze)


def _batch(b, L=10, E=16, vocab=211, seed=0):
    """``test_pipeline.py::_batch``."""
    rng = np.random.default_rng(seed)
    am = np.ones((b, L), np.int32)
    am[:, L - 2 :] = 0  # padded tail
    labels = rng.integers(0, vocab, (b, L)).astype(np.int32)
    labels[am == 0] = -100
    return {
        "token_ids": rng.integers(0, vocab, (b, L)).astype(np.int32),
        "labels": labels,
        "attention_mask": am,
        "image_embedding": rng.normal(size=(b, E)).astype(np.float32),
    }


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         tree)).items()}


# name: (freeze, n_layer, init key, batch seeds, dp, pp, microbatches, kind)
CASES = {
    "pp4_unfrozen": (False, 4, 0, (0,), 1, 4, (2,), "grads"),
    "pp4_frozen": (True, 4, 0, (0,), 1, 4, (2,), "grads"),
    "dp4_pp2": (False, 2, 1, (3,), 4, 2, (1, 2), "grads"),
    "dp2_pp4_step": (False, 4, 2, (10, 11), 2, 4, (2,), "step"),
}
WORLDS = {4: ("pp4_unfrozen", "pp4_frozen"), 8: ("dp4_pp2", "dp2_pp4_step")}


def _case_trees(name):
    freeze, n_layer, key, *_ = CASES[name]
    tr, fz = JC.init_params(jax.random.PRNGKey(key), _cfg(freeze, n_layer))
    return jax.tree.map(np.asarray, tr), jax.tree.map(np.asarray, fz)


def _launch(root, world):
    configs, inputs, cases = {}, {}, []
    for name in WORLDS[world]:
        freeze, n_layer, _, seeds, dp, pp, micro, kind = CASES[name]
        configs[name] = {"gpt2": _gkw(n_layer), "mapping": MKW, "eos": 210, "freeze": freeze}
        tr, fz = _case_trees(name)
        np.savez(root / f"{name}.npz", **{f"{part}/{k}": v for part, tree in (
            ("trainable", tr), ("frozen", fz)) for k, v in _flat(tree).items()})
        for s in seeds:
            inputs.update({f"b{s}_{k}": v for k, v in _batch(8, seed=s).items()})
        cases.append({"name": name, "config": name, "dp": dp, "pp": pp, "micro": list(micro),
                      "kind": kind, "batches": [f"b{s}" for s in seeds]})
    np.savez(root / "inputs.npz", **inputs)
    (root / "spec.json").write_text(json.dumps({"configs": configs, "cases": cases}))
    return launch("pp", str(root), world=world, timeout=180.0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {world: _launch(tmp_path_factory.mktemp(f"pp{world}"), world) for world in WORLDS}


def _close(got: dict, want: dict, atol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=1e-5, err_msg=k)


def _world_of(name):
    return next(w for w, names in WORLDS.items() if name in names)


@pytest.mark.parametrize("name, n_micro", [("pp4_unfrozen", 2), ("pp4_frozen", 2),
                                           ("dp4_pp2", 1), ("dp4_pp2", 2)])
def test_loss_and_grads_match_jax_pipeline(ranks, name, n_micro):
    """``test_pipeline_loss_and_grads_match_single_device`` (pp 4, frozen and
    unfrozen) and ``test_pipeline_dp_pp_combined_and_microbatch_counts``
    ((4, 2), 1 and 2 microbatches): every rank's loss and gathered
    gradients against the JAX pipeline's on the same mesh."""
    freeze, n_layer, _, seeds, dp, pp, _, _ = CASES[name]
    tr, fz = _case_trees(name)
    mesh = JPP.create_pipeline_mesh(dp=dp, pp=pp)
    fn = JPP.make_pipeline_loss_and_grad(_cfg(freeze, n_layer), mesh, JF32,
                                         num_microbatches=n_micro)
    loss, grads = fn(tr, fz, _batch(8, seed=seeds[0]))
    want = _flat(grads)
    got_ranks = ranks[_world_of(name)]
    for r, got in enumerate(got_ranks):
        got = got[name]
        assert got["coords"] == divmod(r, pp)
        np.testing.assert_allclose(got[n_micro]["loss"], float(loss), atol=1e-5, rtol=1e-5)
        _close(got[n_micro]["grads"], want, atol=2e-5)


def test_train_step_matches_jax_pipeline_step(ranks):
    """``test_pipeline_train_step_matches_plain_step``: two AdamW steps of
    the pipeline step on (2, 4) with 2 microbatches: each step's loss and
    the parameters after them against the JAX pipeline step's."""
    tr0, fz = _case_trees("dp2_pp4_step")
    ccfg = _cfg(False, 4)
    opt_cfg = JO.AdamWConfig(learning_rate=1e-3, num_training_steps=10)
    mesh = JPP.create_pipeline_mesh(dp=2, pp=4)
    step, (tr_sh, fz_sh, opt_sh, batch_sh) = JPP.make_pipeline_train_step(
        ccfg, opt_cfg, mesh, JF32, num_microbatches=2)
    tr = jax.device_put(tr0, tr_sh)
    opt = jax.device_put(JO.init(tr0), opt_sh)
    fz = jax.device_put(fz, fz_sh)
    losses = []
    for seed in CASES["dp2_pp4_step"][3]:
        tr, opt, loss, _ = step(tr, opt, fz, jax.device_put(_batch(8, seed=seed), batch_sh))
        losses.append(float(loss))
    want = _flat(tr)
    for got in (r["dp2_pp4_step"] for r in ranks[8]):
        np.testing.assert_allclose(got["losses"], losses, atol=1e-5, rtol=1e-5)
        _close(got["trainable"], want, atol=3e-5)
        assert got["steps"] == 2


def test_pipeline_errors():
    """The JAX package's errors, word for word: layers that pp does not
    divide (``test_pipeline_rejects_indivisible_layers``), a local batch the
    microbatches do not divide, and a mesh the world does not fill."""
    cfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**_gkw(3)), mapping=TM.MLPMappingConfig(**MKW),
                             eos_token_id=210, freeze_gpt_weights=False)
    two = TPP.PipelineMesh(dp=1, pp=2, rank=0, world_size=2, group=None, backend=None,
                           device=torch.device("cpu"), dp_rank=0, stage=0, dp_group=None,
                           pp_group=None)
    for make in (TPP.make_pipeline_loss_and_grad,
                 lambda c, m: TPP.make_pipeline_train_step(c, JO.AdamWConfig(), m)):
        with pytest.raises(ValueError, match=r"^n_layer=3 not divisible by pp=2$"):
            make(cfg, two)
    with pytest.raises(ValueError, match=r"^mesh 1x2 needs 2 devices, have 1$"):
        TPP.create_pipeline_mesh(1, 2, device="cpu")
    one = TPP.create_pipeline_mesh(1, 1, device="cpu")
    assert one.shape == {"dp": 1, "pp": 1} and one.group is None
    tr, fz = TC.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    fn = TPP.make_pipeline_loss_and_grad(cfg, one, F32, num_microbatches=3)
    with pytest.raises(ValueError, match=r"^local batch 8 not divisible by microbatches 3$"):
        fn(tr, fz, _batch(8))
    # a one-stage pipeline is the plain loss and its gradients
    loss, grads = TPP.make_pipeline_loss_and_grad(cfg, one, F32, num_microbatches=2)(
        tr, fz, _batch(8))
    for p in flatten_with_paths(tr).values():
        p.grad = None
    ref = TC.mean_loss(tr, fz, cfg, {k: torch.as_tensor(v) for k, v in _batch(8).items()})
    ref.backward()
    assert float(loss) == pytest.approx(ref.item(), rel=1e-6)
    for k, p in flatten_with_paths(tr).items():
        torch.testing.assert_close(flatten_with_paths(grads)[k], p.grad, atol=1e-6, rtol=1e-5)
