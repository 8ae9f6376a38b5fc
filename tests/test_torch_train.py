"""The port's training path against the JAX package's, in float32 at a tiny
config (GPT-2 2 x 32, vocab 293): the full-sequence forward and its loss,
``loss_fn`` / ``mean_loss`` and their gradients (frozen and unfrozen GPT-2,
both mappers, a task prompt), two AdamW steps, gradient accumulation against
the JAX train step on a one-device CPU mesh, remat, and the ``Batcher``.

Tolerances: losses 1e-5 relative and gradients 1e-4 (float32 on both sides,
summation order only); parameters after optimizer steps 1e-6 (updates are
about lr = 1e-3 in size, so their float32 rounding is far below that).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.mesh import MeshSpec, create_mesh
from gpt2_image_captioning_tpu.core.precision import F32 as J_F32
from gpt2_image_captioning_tpu.data.dataset import Batcher as JBatcher
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.train import loop as JL
from gpt2_image_captioning_tpu.train import optim as JO
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths, tree_leaves, tree_map
from gpt2_image_captioning_tpu_torch.data.dataset import Batcher
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.train import loop as TL
from gpt2_image_captioning_tpu_torch.train import optim as TO

VOCAB, EMB, LEN = 293, 16, 9
MAPPINGS = {
    "mlp": (JM.MLPMappingConfig(prefix_length=3, embed_dim=EMB, gpt_dim=32),
            TM.MLPMappingConfig(prefix_length=3, embed_dim=EMB, gpt_dim=32)),
    "transformer": (JM.TransformerMappingConfig(EMB, 32, 5, 4, num_layers=2, num_heads=4),
                    TM.TransformerMappingConfig(EMB, 32, 5, 4, num_layers=2, num_heads=4)),
}
# mapper, GPT-2 frozen, task prompt ids
VARIANTS = {
    "mlp_frozen": ("mlp", True, None),
    "transformer_frozen": ("transformer", True, None),
    "transformer_unfrozen": ("transformer", False, None),
    "mlp_task_prompt": ("mlp", True, (5, 17, 200)),
}


def _configs(kind="transformer", freeze=True, prompt=None):
    jm, tm = MAPPINGS[kind]
    kw = dict(freeze_gpt_weights=freeze, task_prompt_ids=prompt, eos_token_id=VOCAB - 1)
    return (JC.CaptionerConfig(gpt2=JG.GPT2Config.tiny(), mapping=jm, **kw),
            TC.CaptionerConfig(gpt2=TG.GPT2Config.tiny(), mapping=tm, **kw))


def _params(jcfg, tcfg, seed=0):
    tr, fz = JC.init_params(jax.random.PRNGKey(seed), jcfg)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return tr, fz, ttr, tfz


def _batch(b=4, seed=0) -> dict:
    """Captions as the dataset builds them: ragged lengths, -100 labels and
    mask 0 on the padding."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, size=(b, LEN)).astype(np.int32)
    mask = (np.arange(LEN)[None, :] < rng.integers(3, LEN + 1, size=b)[:, None]).astype(np.int32)
    return {"token_ids": tokens, "labels": np.where(mask == 1, tokens, -100).astype(np.int32),
            "attention_mask": mask,
            "image_embedding": rng.normal(size=(b, EMB)).astype(np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(got, want, atol, rtol=0.0):
    got = flatten_with_paths(got)
    want = flatten_with_paths(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        v = v.detach().numpy() if isinstance(v, torch.Tensor) else v
        np.testing.assert_allclose(v, want[k], atol=atol, rtol=rtol, err_msg=k)


def test_forward_and_cross_entropy_match_jax():
    params = JG.init(jax.random.PRNGKey(0), JG.GPT2Config.tiny())
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    mask = np.ones((3, 7), np.int32)
    mask[1, 5:] = 0
    labels = rng.integers(0, VOCAB, size=(3, 7)).astype(np.int32)
    labels[mask == 0] = -100
    cfg_j, cfg_t = JG.GPT2Config.tiny(), TG.GPT2Config.tiny()
    want_h = JG.forward_hidden(params, cfg_j, jnp.asarray(x), jnp.asarray(mask))
    got_h = TG.forward_hidden(tparams, cfg_t, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    want = JG.forward(params, cfg_j, jnp.asarray(x), jnp.asarray(mask))
    got = TG.forward(tparams, cfg_t, torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 7, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    s, c = TG.cross_entropy_loss(got, torch.from_numpy(labels))
    js, jc = JG.cross_entropy_loss(want, jnp.asarray(labels))
    assert int(c) == int(jc)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    jcfg, tcfg = _configs(*VARIANTS[variant])
    tr, fz, ttr, tfz = _params(jcfg, tcfg)
    batch = _batch()
    js, jc = JC.loss_fn(tr, fz, jcfg, _jb(batch))
    jloss, jgrads = jax.value_and_grad(lambda t: JC.mean_loss(t, fz, jcfg, _jb(batch)))(tr)

    ts, tcount = TC.loss_fn(ttr, tfz, tcfg, _tb(batch))
    assert int(tcount) == int(jc) == int((batch["labels"] != -100).sum())
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    for p in tree_leaves(ttr):
        p.requires_grad_(True)
    loss = TC.mean_loss(ttr, tfz, tcfg, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _assert_trees_close(tree_map(lambda p: p.grad, ttr), jgrads, atol=1e-5, rtol=1e-4)
    assert all(p.grad is None for p in tree_leaves(tfz))


def test_two_optimizer_steps_match_jax():
    """Warmup over two steps (the first at lr 0), clipping at a norm the
    gradients exceed, weight decay 0.01.  The MLP mapper: an attention key
    bias has an exactly-zero gradient (softmax ignores a per-row constant),
    whose float32 rounding noise Adam scales up to ~lr * 1e-2 in either
    direction, so it cannot be held to 1e-6 in any implementation."""
    jcfg, tcfg = _configs("mlp")
    tr, fz, ttr, tfz = _params(jcfg, tcfg, seed=1)
    kw = dict(learning_rate=1e-3, num_warmup_steps=2, num_training_steps=5, max_grad_norm=0.1)
    jopt, topt = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    assert dataclasses.asdict(jopt) == dataclasses.asdict(topt)
    batch = _batch(seed=4)
    state = JO.init(tr)
    optimizer, scheduler = TO.make_optimizer(ttr, topt)
    step = TL.make_train_step(tcfg, topt, F32, device="cpu")
    for _ in range(2):
        jloss, grads = jax.value_and_grad(lambda t: JC.mean_loss(t, fz, jcfg, _jb(batch)))(tr)
        tr, state, jnorm = JO.step(jopt, tr, grads, state)
        loss, norm = step(ttr, optimizer, scheduler, tfz, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
        assert float(norm) > kw["max_grad_norm"]  # the clip engaged
    _assert_trees_close(ttr, tr, atol=1e-6)
    assert [TO.linear_warmup_schedule(topt, s) for s in range(6)] == pytest.approx(
        [float(JO.linear_warmup_schedule(jopt, jnp.asarray(s))) for s in range(6)])


def test_grad_accumulation_matches_jax():
    """Two micro-batches of 2, the second an all-ignored pad from
    ``_group_microbatches``, against the JAX train step on one CPU device."""
    jcfg, tcfg = _configs("mlp")
    tr, fz, ttr, tfz = _params(jcfg, tcfg, seed=2)
    micro = _batch(b=2, seed=5)
    group = TL._group_microbatches([dict(micro)], 2)
    want_group = JL._group_microbatches([dict(micro)], 2)
    for k in want_group:
        np.testing.assert_array_equal(group[k], want_group[k])
    assert (group["labels"][1] == -100).all()
    group["labels"][1] = micro["labels"]  # a second real micro-batch
    kw = dict(learning_rate=1e-3, num_training_steps=3)
    mesh = create_mesh(MeshSpec(dp=1, tp=1), devices=jax.devices()[:1])
    jstep, (tr_sh, fr_sh, opt_sh, b_sh) = JL.make_train_step(jcfg, JO.AdamWConfig(**kw), mesh,
                                                             J_F32, grad_accum_steps=2)
    jtr, _, jloss, jnorm = jstep(jax.device_put(tr, tr_sh), jax.device_put(JO.init(tr), opt_sh),
                                 jax.device_put(fz, fr_sh), jax.device_put(group, b_sh), {})
    optimizer, scheduler = TO.make_optimizer(ttr, TO.AdamWConfig(**kw))
    step = TL.make_train_step(tcfg, TO.AdamWConfig(**kw), F32, grad_accum_steps=2, device="cpu")
    loss, norm = step(ttr, optimizer, scheduler, tfz, group)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    _assert_trees_close(ttr, jtr, atol=1e-6)


def test_remat_gives_identical_loss_and_grads():
    jcfg, tcfg = _configs("transformer", freeze=False)
    _, _, ttr, tfz = _params(jcfg, tcfg)
    batch = _tb(_batch())
    results = []
    for cfg in (tcfg, dataclasses.replace(tcfg, remat=True)):
        tr = {k: v for k, v in ttr.items()}
        for p in tree_leaves(tr):
            p.grad = None
            p.requires_grad_(True)
        loss = TC.mean_loss(tr, tfz, cfg, batch)
        loss.backward()
        results.append((loss.detach(), [p.grad.clone() for p in tree_leaves(tr)]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


class _Captions:
    """An in-memory dataset with the two methods a batcher uses."""

    def __init__(self, n):
        self.data = _batch(b=n, seed=7)
        self.data["image_id"] = np.arange(n, dtype=np.int64)

    def __len__(self):
        return len(self.data["token_ids"])

    def gather_batch(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


def test_batcher_matches_jax():
    ds = _Captions(10)
    ours, theirs = Batcher(ds, 4, seed=3), JBatcher(ds, 4, seed=3)
    assert ours.steps_per_epoch == theirs.steps_per_epoch == 3
    for epoch in (0, 1, None, None):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert (got[-1]["labels"][2:] == -100).all()  # 10 = 4 + 4 + 2 real rows
    assert not (ds.data["labels"] == -100).all(axis=1).any()  # padding never leaks back


def test_ten_steps_on_one_batch_lower_the_loss():
    _, tcfg = _configs("transformer")
    ttr, tfz = TC.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    ocfg = TO.AdamWConfig(learning_rate=1e-3, num_training_steps=10)
    optimizer, scheduler = TO.make_optimizer(ttr, ocfg)
    step = TL.make_train_step(tcfg, ocfg, F32, device="cpu")
    batch = _batch(seed=9)
    losses = [float(step(ttr, optimizer, scheduler, tfz, batch)[0]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
