"""The port's sequence parallelism (``parallel/sequence.py``) and ring
attention (``parallel/ring.py``) against the JAX package's, at
``tests/test_sequence_parallel.py``'s and ``tests/test_ring_attention.py``'s
configs (GPT-2 2 x 32 with 4 heads over 211 ids, the MLP mapper with prefix
3) and tolerances, the JAX side on the conftest's virtual 8-device mesh.

One launch of eight gloo ranks (``tests/torch_dist_worker.py``, task
``sp``) on a (dp, sp) = (2, 4) mesh runs every case:

- the all-gather form, GPT-2 unfrozen and frozen (prefix 3 + caption 13 =
  16 rows), and padded (caption 11: 14 rows padded to 16); the ring form
  padded, unfrozen and frozen (the frozen ring is the case where the
  mapper's gradient reaches it only through ``ring_permute``'s backward):
  loss atol / rtol 1e-5, gradients atol 2e-5 (rtol 1e-5), against both
  the JAX ``make_sp_loss_and_grad`` and the JAX ``captioner.mean_loss``;
- ``ring_attention`` on each rank's chunk against ``attention_xla`` on the
  whole sequence, causal and not, and with a key mask, forward and q/k/v
  gradients;
- the collectives a rank makes in one loss's forward and backward, counted
  by patching ``torch.distributed`` in the rank: the all-gather form
  gathers 2 · n_layer times a forward, the ring form never, and its
  backward's exchanges run the other way round the ring; every block's
  products see T/sp rows.

The mesh errors and the one-rank mesh run in this process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.ops import nn as jnn
from gpt2_image_captioning_tpu.parallel import sequence as JSP
from gpt2_image_captioning_tpu.parallel.ring import ring_attention as jring
from gpt2_image_captioning_tpu_torch import parallel as TP
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.parallel import sequence as TS

from torch_dist_worker import launch

GKW = dict(vocab_size=211, n_positions=64, n_embd=32, n_layer=2, n_head=4)
MKW = dict(prefix_length=3, embed_dim=16, gpt_dim=32)
DP, SP = 2, 4


def _cfg(freeze=False):
    """``test_sequence_parallel.py::_cfg``."""
    return JC.CaptionerConfig(gpt2=JG.GPT2Config(**GKW), mapping=JM.MLPMappingConfig(**MKW),
                              eos_token_id=210, freeze_gpt_weights=freeze)


def _batch(b, L, vocab=211, seed=0):
    """``test_sequence_parallel.py::_batch``."""
    rng = np.random.default_rng(seed)
    am = np.ones((b, L), np.int32)
    am[:, L - 2:] = 0
    labels = rng.integers(0, vocab, (b, L)).astype(np.int32)
    labels[am == 0] = -100
    return {
        "token_ids": rng.integers(0, vocab, (b, L)).astype(np.int32),
        "labels": labels,
        "attention_mask": am,
        "image_embedding": rng.normal(size=(b, 16)).astype(np.float32),
    }


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         tree)).items()}


# name: (freeze, init key, L, batch seed, ring) — the JAX tests' cases, and
# the frozen ring, which they lack
CASES = {
    "ag_unfrozen": (False, 0, 13, 0, False),
    "ag_frozen": (True, 0, 13, 0, False),
    "ag_padded": (False, 1, 11, 5, False),
    "ring_padded": (False, 0, 11, 5, True),
    "ring_frozen": (True, 0, 11, 5, True),
}
# name: (causal, key mask, b) — test_ring_attention.py's inputs
RING_CASES = {"causal": (True, False, 2), "bidirectional": (False, False, 2),
              "masked": (True, True, 3)}
PROBE_L = 13  # 16 rows: 4 a rank


def _config_name(freeze, key):
    return f"f{int(freeze)}_k{key}"


def _trees(freeze, key):
    tr, fz = JC.init_params(jax.random.PRNGKey(key), _cfg(freeze))
    return jax.tree.map(np.asarray, tr), jax.tree.map(np.asarray, fz)


def _ring_inputs(name):
    """q, k, v (B, 4, 16, 8), the output weights w and the key mask."""
    causal, masked, b = RING_CASES[name]
    rng = np.random.default_rng(10 + list(RING_CASES).index(name))
    q, k, v, w = (rng.normal(size=(b, 4, 16, 8)).astype(np.float32) for _ in range(4))
    km = np.ones((b, 16), np.int32)
    km[:, 13:] = 0
    km[0, 5] = 0
    return q, k, v, w, km


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    configs, inputs, cases = {}, {}, []
    for name, (freeze, key, L, seed, ring) in CASES.items():
        cname = _config_name(freeze, key)
        if cname not in configs:
            configs[cname] = {"gpt2": GKW, "mapping": MKW, "eos": 210, "freeze": freeze}
            tr, fz = _trees(freeze, key)
            np.savez(root / f"{cname}.npz", **{f"{part}/{k}": v for part, tree in (
                ("trainable", tr), ("frozen", fz)) for k, v in _flat(tree).items()})
        inputs.update({f"{name}_{k}": v for k, v in _batch(8, L, seed=seed).items()})
        cases.append({"name": name, "config": cname, "batch": name, "ring": ring})
    inputs.update({f"probe_{k}": v for k, v in _batch(4, PROBE_L).items()})
    for name in RING_CASES:
        inputs.update({f"{name}_{t}": a for t, a in zip("qkvwm", _ring_inputs(name))})
        inputs[f"{name}_mask"] = inputs.pop(f"{name}_m")
    np.savez(root / "inputs.npz", **inputs)
    spec = {"configs": configs, "cases": cases, "mesh": [DP, SP], "probe": _config_name(False, 0),
            "ring_cases": [[n, c, m] for n, (c, m, _) in RING_CASES.items()]}
    (root / "spec.json").write_text(json.dumps(spec))
    return launch("sp", str(root), world=DP * SP, timeout=240.0)


def _close(got: dict, want: dict, atol: float) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=1e-5, err_msg=k)


def test_ranks_sit_on_the_grid(ranks):
    """Rank r is (r // sp, r % sp): the sp ranks of one dp index contiguous."""
    for r, got in enumerate(ranks):
        assert got["coords"] == divmod(r, SP)
        assert got["mesh"]["backend"] == "gloo"


@pytest.mark.parametrize("name", sorted(CASES))
def test_sp_loss_and_grads_match_jax(ranks, name):
    """Every rank's loss and gradients against the JAX ``make_sp_loss_and_grad``
    on its (2, 4) mesh and against the JAX ``mean_loss`` on one device."""
    freeze, key, L, seed, ring = CASES[name]
    tr, fz = _trees(freeze, key)
    batch = _batch(8, L, seed=seed)
    ccfg = _cfg(freeze)
    ref_loss, ref_g = jax.value_and_grad(lambda t: JC.mean_loss(t, fz, ccfg, batch, JF32))(tr)
    fn = JSP.make_sp_loss_and_grad(ccfg, JSP.create_sp_mesh(dp=DP, sp=SP), JF32, ring=ring)
    sp_loss, sp_g = fn(tr, fz, batch)
    for got in ranks:
        got = got[name]
        for loss, grads in ((ref_loss, ref_g), (sp_loss, sp_g)):
            np.testing.assert_allclose(got["loss"], float(loss), atol=1e-5, rtol=1e-5)
            _close(got["grads"], _flat(grads), atol=2e-5)
    if freeze:  # the mapper's gradient is all there is, and it is not zero
        assert all(k.startswith("mapping") for k in ranks[0][name]["grads"])
        assert max(np.abs(v).max() for v in ranks[0][name]["grads"].values()) > 1e-4


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_full_attention(ranks, name):
    """``test_ring_matches_full_attention``, ``_respects_key_mask_and_offsets``
    and ``_gradients_match_full_attention``: the chunks of the four sp ranks
    of each dp index, joined, against ``attention_xla`` on the whole
    sequence, forward and q/k/v gradients; the JAX ring on the same chunks
    too."""
    causal, masked, _ = RING_CASES[name]
    q, k, v, w, km = (jnp.asarray(a) for a in _ring_inputs(name))
    km = km if masked else None

    def full(q, k, v):
        return jnp.sum(jnn.attention_xla(q, k, v, causal=causal, key_mask=km, policy=JF32) * w)

    want_out = jnn.attention_xla(q, k, v, causal=causal, key_mask=km, policy=JF32)
    want_grads = jax.grad(full, argnums=(0, 1, 2))(q, k, v)
    mesh = JSP.create_sp_mesh(dp=1, sp=SP)
    spec = P(None, None, JSP.SEQ_AXIS, None)

    def inner(q, k, v):
        sid = jax.lax.axis_index(JSP.SEQ_AXIS)
        return jring(q, k, v, axis_name=JSP.SEQ_AXIS, q_offset=sid * 4, key_mask=km,
                     causal=causal, policy=JF32)

    jax_out = shard_map(inner, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                        check_vma=False)(q, k, v)
    for d in range(DP):
        chunks = [ranks[d * SP + s][name] for s in range(SP)]
        out = np.concatenate([c["out"] for c in chunks], axis=2)
        for ref in (want_out, jax_out):
            np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)
        for i, g in enumerate(want_grads):
            got = np.concatenate([c["grads"][i] for c in chunks], axis=2)
            np.testing.assert_allclose(got, np.asarray(g), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("ring", [False, True])
def test_collectives_and_block_rows(ranks, ring):
    """``test_sp_activation_chunking_is_real`` and
    ``test_ring_program_has_no_all_gather``, counted in each rank: the
    all-gather form gathers K and V each layer (2 · n_layer), reduce-scatters
    their gradients as many times and exchanges nothing point to point; the ring form gathers nothing and exchanges K
    and V (sp - 1) times a layer, sending to the next sp rank and receiving
    from the previous one, its backward as many times the other way.  Each
    block's products see the rank's 2 rows x 4 of the 16."""
    n_layer = GKW["n_layer"]
    for r, got in enumerate(ranks):
        probe = got[f"probe_ring{int(ring)}"]
        fwd, total = probe["forward"], probe["total"]
        d, s = divmod(r, SP)
        nxt, prv = d * SP + (s + 1) % SP, d * SP + (s - 1) % SP
        assert set(fwd["block_rows"]) == {(2, 16 // SP)}
        assert len(fwd["block_rows"]) == 4 * n_layer  # qkv, attn_proj, fc, mlp_proj
        assert fwd["all_reduce"] == 1  # the token count
        if not ring:
            assert fwd["all_gather"] == 2 * n_layer and fwd["batch_isend_irecv"] == []
            assert total["all_gather"] == 2 * n_layer and total["batch_isend_irecv"] == []
            assert total["reduce_scatter"] == 2 * n_layer  # each gather's backward
            assert total["all_reduce"] == 1
        else:
            n_ex = 2 * n_layer * (SP - 1)
            assert fwd["all_gather"] == total["all_gather"] == 0
            assert fwd["batch_isend_irecv"] == [[("send", nxt), ("recv", prv)]] * n_ex
            back = total["batch_isend_irecv"][n_ex:]
            assert back == [[("send", prv), ("recv", nxt)]] * n_ex
            assert total["all_reduce"] == 1 and total["reduce_scatter"] == 0


def _torch_cfg(freeze=False):
    return TC.CaptionerConfig(gpt2=TG.GPT2Config(**GKW), mapping=TM.MLPMappingConfig(**MKW),
                              eos_token_id=210, freeze_gpt_weights=freeze)


def test_create_sp_mesh_errors_and_names():
    """The JAX error with ranks for devices; a one-rank mesh without a
    process group; the names on ``parallel``'s first use."""
    with pytest.raises(ValueError, match=r"^mesh 2x4 needs 8 ranks, have 1$"):
        TS.create_sp_mesh(2, 4, device="cpu")
    one = TS.create_sp_mesh(1, 1, device="cpu")
    assert one.shape == {"dp": 1, "sp": 1} and one.group is None and one.sp_group is None
    assert TP.SEQ_AXIS == JSP.SEQ_AXIS == "sp"
    assert (TP.create_sp_mesh, TP.make_sp_loss_and_grad, TP.pad_batch_for_sp) == (
        TS.create_sp_mesh, TS.make_sp_loss_and_grad, TS.pad_batch_for_sp)


def test_pad_batch_for_sp_matches_jax():
    """14 rows padded to 16 for sp 4 as the JAX function pads them (token 0,
    label -100, mask 0); a batch that needs nothing is returned itself."""
    batch = _batch(3, 11)
    want = JSP.pad_batch_for_sp(batch, 3, 4)
    got = TS.pad_batch_for_sp({k: torch.from_numpy(v) for k, v in batch.items()}, 3, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    even = {k: torch.from_numpy(v) for k, v in _batch(3, 13).items()}
    assert TS.pad_batch_for_sp(even, 3, 4) is even
    with pytest.raises(ValueError, match=r"^sequence length 14 not divisible by sp=4; "):
        mesh = TS.SequenceMesh(dp=1, sp=4, rank=0, world_size=4, group=None, backend=None,
                               device=torch.device("cpu"), dp_rank=0, sp_rank=0,
                               dp_group=None, sp_group=None)
        tr, fz = TC.init_params(torch.Generator().manual_seed(0), _torch_cfg(), device="cpu")
        TS._shard_loss(_torch_cfg(), mesh, F32, False, tr, fz,
                       {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("ring", [False, True])
def test_one_rank_mesh_is_the_plain_loss(ring):
    """On a mesh of one rank both forms are the port's ``mean_loss`` and its
    gradients, padding included."""
    cfg = _torch_cfg()
    tr, fz = TC.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _batch(4, 11, seed=5)
    loss, grads = TS.make_sp_loss_and_grad(cfg, TS.create_sp_mesh(1, 1, device="cpu"), F32,
                                           ring=ring)(tr, fz, batch)
    params = flatten_with_paths(tr)
    assert all(p.grad is None for p in params.values())
    ref = TC.mean_loss(tr, fz, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    ref.backward()
    assert float(loss) == pytest.approx(ref.item(), rel=1e-6)
    for k, g in flatten_with_paths(grads).items():
        torch.testing.assert_close(g, params[k].grad, atol=1e-6, rtol=1e-5)
