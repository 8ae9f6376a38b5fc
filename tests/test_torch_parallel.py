"""The port's mesh and collectives against the JAX package's: ``MeshSpec``
resolution and its errors over a table of shapes, ``create_mesh`` with no
process group, ``psum_scalar`` / ``pmean_scalar`` / ``all_gather_batch`` on
two gloo ranks (subprocesses, ``tests/torch_dist_worker.py``) against the
JAX collectives on a dp-2 mesh of virtual CPU devices, and the ``Batcher``'s
process shards against the JAX ``Batcher``'s for 1, 2 and 4 processes."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core import mesh as JMesh
from gpt2_image_captioning_tpu.data.dataset import Batcher as JBatcher
from gpt2_image_captioning_tpu.parallel import collectives as JP
from gpt2_image_captioning_tpu_torch.core import mesh as TMesh
from gpt2_image_captioning_tpu_torch.data.dataset import Batcher as TBatcher
from gpt2_image_captioning_tpu_torch.parallel import collectives as TP

from torch_dist_worker import launch

RESOLVE = [(-1, 1, 1), (-1, 1, 4), (2, 1, 2), (4, 2, 8), (-1, 2, 8), (-1, 0, 3), (2, 1, 1),
           (8, 1, 1), (1, 1, 2), (-1, 3, 4), (3, 2, 8)]


def _outcome(spec, n):
    try:
        return spec.resolve(n)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("dp, tp, n", RESOLVE)
def test_mesh_spec_resolve_matches_jax(dp, tp, n):
    """Each (dp, tp) against n devices resolves as in the JAX package, or
    raises its error word for word."""
    assert _outcome(TMesh.MeshSpec(dp, tp), n) == _outcome(JMesh.MeshSpec(dp, tp), n)
    assert TMesh.MeshSpec() == TMesh.MeshSpec(dp=-1, tp=1)
    assert (TMesh.DATA_AXIS, TMesh.MODEL_AXIS) == (JMesh.DATA_AXIS, JMesh.MODEL_AXIS)


def test_create_mesh_without_a_group():
    """With no process group: dp -1 (and 1) is a one-rank mesh on the asked
    device with no group, dp 2 raises ``resolve``'s error, tp 2 refuses
    naming its ROADMAP item; its collectives are the identity."""
    assert not torch.distributed.is_initialized()
    mesh = TMesh.create_mesh(device="cpu")
    assert (mesh.dp, mesh.tp, mesh.rank, mesh.world_size, mesh.group, mesh.backend) == (
        1, 1, 0, 1, None, None)
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.device == torch.device("cpu") and mesh.is_main
    assert TMesh.create_mesh(TMesh.MeshSpec(dp=1), device="cpu") == mesh
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        TMesh.create_mesh(TMesh.MeshSpec(dp=2), device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1: tensor parallelism"):
        TMesh.create_mesh(TMesh.MeshSpec(dp=1, tp=2), device="cpu")
    x = torch.arange(6.0)
    assert float(TP.psum_scalar(mesh, x)) == 15.0 and float(TP.pmean_scalar(mesh, x)) == 2.5
    assert TP.all_gather_batch(mesh, x) is x
    batch = TMesh.shard_batch(mesh, {"a": np.arange(4), "b": [np.ones((4, 2))]})
    assert torch.equal(batch["a"], torch.arange(4)) and batch["b"][0].shape == (4, 2)


def test_layout_chooses_the_backend():
    """gloo on the CPU and when ranks share a card; nccl when each rank has
    one, also when a launcher shows each rank only its own card (decided
    from the cards' identities, never by trying)."""
    assert TMesh.device_identity(torch.device("cpu")) == "cpu"
    assert TMesh.layout_backend(["cpu"]) == "gloo"
    assert TMesh.layout_backend(["cpu"] * 4) == "gloo"
    assert TMesh.layout_backend(["cuda:GPU-a"]) == "nccl"
    assert TMesh.layout_backend(["cuda:GPU-a", "cuda:GPU-b"]) == "nccl"
    assert TMesh.layout_backend(["cuda:GPU-a", "cuda:GPU-a"]) == "gloo"
    assert TMesh.layout_backend(["cuda:GPU-a", "cuda:GPU-b", "cuda:GPU-a"]) == "gloo"
    assert TMesh.layout_backend(["cuda:GPU-a", "cpu"]) == "gloo"


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    root = tmp_path_factory.mktemp("collectives")
    x = np.random.default_rng(0).normal(size=(8,)).astype(np.float32)
    np.savez(root / "inputs.npz", x=x)
    (root / "spec.json").write_text(json.dumps({}))
    return x, launch("collectives", str(root))


def test_collectives_match_jax_on_two_ranks(collectives):
    """Each rank's contiguous shard of an 8-vector: the sums, means and the
    gather equal the JAX collectives' on a dp-2 mesh, on both ranks."""
    x, ranks = collectives
    mesh = JMesh.create_mesh(JMesh.MeshSpec(dp=2, tp=1), devices=jax.devices()[:2])
    xs = jax.device_put(jnp.asarray(x), JMesh.batch_sharding(mesh))
    want = {"psum": float(JP.psum_scalar(mesh, xs)), "pmean": float(JP.pmean_scalar(mesh, xs)),
            "gather": np.asarray(JP.all_gather_batch(mesh, xs))}
    for r, got in enumerate(ranks):
        assert got["mesh"] == {"dp": 2, "rank": r, "backend": "gloo"}
        np.testing.assert_array_equal(got["local"], x[4 * r:4 * r + 4])
        np.testing.assert_allclose(got["psum"], want["psum"], rtol=1e-6)
        np.testing.assert_allclose(got["pmean"], want["pmean"], rtol=1e-6)
        np.testing.assert_array_equal(got["gather"], want["gather"])


def test_psum_tensors_on_two_ranks(collectives):
    """The in-place sum of a list of tensors over the ranks (the train step's
    gradient reduction), the same bits on both ranks."""
    x, ranks = collectives
    want = [x[:4] + x[4:], np.float32(2) * (x[:1] + x[4:5])]
    for got in ranks:
        for g, w in zip(got["psum_tensors"], want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    for a, b in zip(ranks[0]["psum_tensors"], ranks[1]["psum_tensors"]):
        np.testing.assert_array_equal(a, b)


class _Rows:
    """A dataset of ``n`` rows whose labels name the row."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def gather_batch(self, idx):
        return {"labels": np.stack([np.full(3, i, np.int64) for i in idx]),
                "image_id": np.asarray(idx)}


@pytest.mark.parametrize("count", [1, 2, 4])
def test_batcher_shards_match_jax(count):
    """Each process's shard equals the JAX ``Batcher``'s with the same
    coordinates; the shards' union is the one-process global batch; the
    padded tail's rows are labelled -100 on whichever process holds them."""
    ds, bs = _Rows(11), 4
    for epoch in range(2):
        glob = list(TBatcher(ds, bs, seed=3).epoch(epoch))
        shards = [list(TBatcher(ds, bs, seed=3, process_index=i, process_count=count)
                       .epoch(epoch)) for i in range(count)]
        jshards = [list(JBatcher(ds, bs, seed=3, process_index=i, process_count=count)
                        .epoch(epoch)) for i in range(count)]
        for step, whole in enumerate(glob):
            parts = [s[step] for s in shards]
            for part, jpart in zip(parts, (s[step] for s in jshards)):
                for k in part:
                    np.testing.assert_array_equal(part[k], jpart[k])
            for k in whole:
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), whole[k])
        last = np.concatenate([s[-1]["labels"] for s in shards])
        assert (last[3:] == -100).all() and (last[:3] >= 0).all()  # 11 = 2 x 4 + 3
    with pytest.raises(ValueError, match="not divisible by process_count 3"):
        TBatcher(ds, bs, process_count=3)
