"""The port's binding of the C++ vector index and its host stores against
the JAX package's (``retrieval/hnsw.py``, ``retrieval/store.py``,
``retrieval/indexing.py``) on the CPU:

- the binding finds no library and compiles ``native/hnsw/hnsw.cpp`` into
  its build folder (``_build/`` by default) with the Makefile's flags;
- flat search exact, HNSW recall at the reference's defaults, both
  packages' indices giving the same ids on the same data;
- ``VectorStore`` (hnsw and flat) and ``PersistentVectorStore`` files:
  each package opens the other's and retrieves the same captions;
- the flat store returns the device store's images;
- the indexing CLI (``python -m ...retrieval.indexing``) for every backend.

Where the JAX package's binding finds no ``native/build/libhnsw.so``, the
fixture points it at the library the port compiled: both read the same
source.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.retrieval import exact as JE
from gpt2_image_captioning_tpu.retrieval import hnsw as JH
from gpt2_image_captioning_tpu.retrieval import store as JS
from gpt2_image_captioning_tpu_torch.data.embeddings_io import save_embeddings
from gpt2_image_captioning_tpu_torch.retrieval import exact as TE
from gpt2_image_captioning_tpu_torch.retrieval import hnsw as TH
from gpt2_image_captioning_tpu_torch.retrieval import indexing as TI
from gpt2_image_captioning_tpu_torch.retrieval import store as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding's library: native/build's, else the port's build."""
    if not JH.available():
        JH._LIB_PATHS[:] = [str(TH.compile_library())]
        JH._lib = None
    assert JH.available() and TH.available()


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, centres=20, spread=0.3):
    """Unit vectors around a few centres, as embeddings of real images lie."""
    c = _unit(rng, centres, d)
    x = c[rng.integers(0, centres, size=n)] + spread / np.sqrt(d) * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    n, d = 300, 32
    names = [f"COCO_train2017_{i:012d}.jpg" for i in range(n)]
    emb = _clustered(rng, n, d)
    entries, cid = [], 0
    for i, f in enumerate(names):
        caps = []
        for _ in range(int(rng.integers(1, 7))):
            caps.append({"caption_id": cid, "embedding": torch.from_numpy(_unit(rng, 1, d)[0])})
            cid += 1
        entries.append({"filenames": f, "embeddings": caps})
    return names, emb, entries


def test_binding_compiles_the_source_when_no_library(tmp_path, monkeypatch):
    """No prebuilt library: the first use runs g++ on native/hnsw/hnsw.cpp
    into the build folder, and loads that file; a second build finds it."""
    assert TH.BUILD_DIR == TH.REPO_DIR / "gpt2_image_captioning_tpu_torch" / "_build"
    assert TH.SOURCE == TH.REPO_DIR / "native" / "hnsw" / "hnsw.cpp"
    monkeypatch.setattr(TH, "_prebuilt", lambda: None)
    monkeypatch.setattr(TH, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(TH, "_lib", None)
    lib = TH.lib()
    built = sorted((tmp_path / "_build").glob("hnsw-*/libhnsw.so"))
    assert len(built) == 1 and os.path.samefile(lib._name, built[0])
    assert not list((tmp_path / "_build").glob("hnsw-*/*.so.*")) and \
        [p.name for p in built[0].parent.iterdir()] == ["libhnsw.so"]
    mtime = built[0].stat().st_mtime_ns
    assert TH.compile_library() == built[0] and built[0].stat().st_mtime_ns == mtime
    idx = TH.FlatIPIndex(4)
    idx.add(np.eye(4, dtype=np.float32))
    assert len(idx) == 4 and idx.search(np.eye(4, dtype=np.float32)[:1], 1)[1][0, 0] == 0


def test_flat_exact_and_hnsw_recall(corpus):
    _, x, _ = corpus
    q = _clustered(np.random.default_rng(1), 40, x.shape[1])
    flat = TH.FlatIPIndex(x.shape[1])
    flat.add(x)
    scores, ids = flat.search(q, 6)
    want = np.argsort(-(q.astype(np.float64) @ x.T.astype(np.float64)), axis=1, kind="stable")
    np.testing.assert_array_equal(ids, want[:, :6])
    hnsw = TH.HNSWIndex(x.shape[1])  # M 32, ef_construction 200, ef_search 64
    hnsw.add(x)
    _, hids = hnsw.search(q, 6)
    recall = np.mean([len(set(a) & set(b)) / 6 for a, b in zip(hids, ids)])
    assert recall >= 0.95, recall
    assert len(hnsw) == len(flat) == len(x)
    np.testing.assert_allclose(hnsw.reconstruct(3), x[3], atol=1e-6)
    jh = JH.HNSWIndex(x.shape[1])
    jh.add(x)
    np.testing.assert_array_equal(jh.search(q, 6)[1], hids)  # one library, one seed


@pytest.mark.parametrize("backend", ["hnsw", "flat"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_vector_store_files_cross_load(corpus, backend, writer, tmp_path):
    names, emb, entries = corpus
    mod_w, mod_r = (TS, JS) if writer == "port" else (JS, TS)
    built = mod_w.create_store(names, emb, entries, backend=backend)
    built.save(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["caption.index", "image.index", "store_meta.json"]
    loaded = mod_r.VectorStore.load(str(tmp_path))
    q = np.concatenate([emb[:4], _clustered(np.random.default_rng(3), 4, emb.shape[1])])
    for store in (built, loaded):
        hits = store.retrieve_images_by_vector_similarity(q, 3)
        assert all(names[i] not in [f for f, _ in row] for i, row in zip(range(4), hits))
    want = built.retrieve_images_by_vector_similarity(q, 3)
    got = loaded.retrieve_images_by_vector_similarity(q, 3)
    assert [[f for f, _ in r] for r in got] == [[f for f, _ in r] for r in want]
    fn = [[f for f, _ in r] for r in want]
    np.testing.assert_array_equal(loaded.get_caption_embeddings(10, fn),
                                  built.get_caption_embeddings(10, fn))
    np.testing.assert_array_equal(loaded.caption_ids, built.caption_ids)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_persistent_store_cross_load(corpus, writer, tmp_path):
    names, emb, entries = corpus
    mod_w, mod_r = (TS, JS) if writer == "port" else (JS, TS)
    built = mod_w.create_persistent_store(str(tmp_path / "db"), names, emb, entries)
    loaded = mod_r.PersistentVectorStore(str(tmp_path / "db"))
    np.testing.assert_array_equal(loaded.caption_image_similarity, built.caption_image_similarity)
    q = _clustered(np.random.default_rng(4), 5, emb.shape[1])
    for i in range(len(q)):
        np.testing.assert_array_equal(loaded.retrieve_for_single_embedding(q[i], 4, 10),
                                      built.retrieve_for_single_embedding(q[i], 4, 10))
    want = built.retrieve_images_by_vector_similarity(q, 4)
    assert loaded.retrieve_images_by_vector_similarity(q, 4) == want


def test_flat_store_returns_the_device_store_images(corpus):
    """The flat index and the exact device store rank the same images and
    gather the same captions (no ties among these similarities)."""
    names, emb, entries = corpus
    flat = TS.create_store(names, emb, entries, backend="flat")
    dev = TE.DeviceVectorStore.build(names, emb, entries, device="cpu")
    q = np.concatenate([emb[10:14], _clustered(np.random.default_rng(5), 12, emb.shape[1])])
    want = TE.retrieve_images_by_vector_similarity(dev, q, 4)
    got = flat.retrieve_images_by_vector_similarity(q, 4)
    assert [[f for f, _ in r] for r in got] == [[f for f, _ in r] for r in want]
    fn = [[f for f, _ in r] for r in got]
    np.testing.assert_allclose(flat.get_caption_embeddings(10, fn),
                               dev.retrieve_fused(q, 4, 10).numpy(), atol=0)
    jdev = JE.DeviceVectorStore.build(names, emb, entries)
    np.testing.assert_array_equal(JE.get_caption_embeddings(jdev, 10, fn),
                                  TE.get_caption_embeddings(dev, 10, fn))


@pytest.mark.parametrize("backend", ["hnsw", "flat", "persistent"])
def test_indexing_cli(corpus, backend, tmp_path):
    """``python -m ...retrieval.indexing`` on the artifacts' files writes the
    store the JAX package's loader opens, retrieving as the in-memory one."""
    names, emb, entries = corpus
    save_embeddings(str(tmp_path / "train_clip_embeddings.pt"), names, emb)
    torch.save(entries, str(tmp_path / "train_clip_caption_embeddings.pt"))
    out = tmp_path / "store"
    args = ["--image-embeddings", str(tmp_path / "train_clip_embeddings.pt"),
            "--caption-embeddings", str(tmp_path / "train_clip_caption_embeddings.pt"),
            "--output-dir", str(out), "--backend", backend]
    if backend == "flat":  # the module run as a program
        proc = subprocess.run(
            [sys.executable, "-m", "gpt2_image_captioning_tpu_torch.retrieval.indexing", *args],
            capture_output=True, text=True, cwd=REPO, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "Store saved to" in proc.stdout
    else:
        TI.main(args)
    q = emb[:3] * 0.9 + _clustered(np.random.default_rng(6), 3, emb.shape[1]) * 0.1
    if backend == "persistent":
        loaded = JS.PersistentVectorStore(str(out))
        mem = TS.create_persistent_store(str(tmp_path / "again"), names, emb, entries)
    else:
        loaded = JS.VectorStore.load(str(out))
        assert json.loads((out / "store_meta.json").read_text())["backend"] == backend
        mem = TS.create_store(names, emb, entries, backend=backend)
    assert loaded.retrieve_images_by_vector_similarity(q, 3) == \
        mem.retrieve_images_by_vector_similarity(q, 3)
