"""The port's exact device retrieval against the JAX package's
(``retrieval/exact.py``) on the CPU: ``DeviceVectorStore.build``'s tables,
``fused_retrieve``'s caption rows and the image ranking under the
self-match filter (an exact duplicate of the query is dropped too),
duplicated store rows (ties: the lower index first, as ``lax.top_k``),
images with fewer captions than ``top_k``, and more top_i slots than
captions; ``search_images`` and the host-facing functions.

Tie cases use vectors whose inner products are exact in float32 (entries of
±1/4 and 1/2), so both packages see the same equal similarities whatever
their summation order; the random cases use normalised Gaussian vectors
(their similarities differ by an ulp between the two products, far below
their gaps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.retrieval import exact as JE
from gpt2_image_captioning_tpu_torch.retrieval import exact as TE


def _entries(filenames, per_image, dim, rng, skip=()):
    """The grouped caption artifact: image i has per_image[i] captions."""
    out, cid = [], 100
    for f, n in zip(filenames, per_image):
        if f in skip:
            continue
        embs = []
        for _ in range(n):
            v = rng.normal(size=dim).astype(np.float32)
            embs.append({"caption_id": cid, "embedding": torch.from_numpy(v / np.linalg.norm(v))})
            cid += 1
        out.append({"filenames": f, "embeddings": embs})
    return out


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _stores(filenames, image_emb, entries):
    return (JE.DeviceVectorStore.build(filenames, image_emb, entries),
            TE.DeviceVectorStore.build(filenames, image_emb, entries, device="cpu"))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    n, d = 40, 16
    names = [f"img_{i:03d}.jpg" for i in range(n)]
    per_image = rng.integers(0, 8, size=n)  # 0-7 captions; some images have none
    entries = _entries(names, per_image, d, rng, skip={"img_005.jpg"})
    entries.append({"filenames": "not_in_store.jpg", "embeddings": []})
    return names, _unit(rng, n, d), entries


def test_build_tables_equal(corpus):
    names, emb, entries = corpus
    js, ts = _stores(names, emb, entries)
    np.testing.assert_array_equal(ts.caption_table.numpy(), np.asarray(js.caption_table))
    np.testing.assert_array_equal(ts.caption_embeddings.numpy(), np.asarray(js.caption_embeddings))
    np.testing.assert_array_equal(ts.image_embeddings.numpy(), np.asarray(js.image_embeddings))
    np.testing.assert_array_equal(ts.caption_ids, js.caption_ids)
    assert ts.image_filenames == js.image_filenames and ts.filename_to_index == js.filename_to_index
    assert sorted(ts.arrays()) == ["caption_embeddings", "caption_table", "image_embeddings"]


@pytest.mark.parametrize("top_i, top_k", [(4, 10), (1, 3), (6, 20), (3, 40)])
def test_fused_retrieve_matches_jax(corpus, top_i, top_k):
    """Random queries, the store's own rows among them (self-matches): the
    same caption rows, zero padding where the images run out of captions;
    (3, 40): the three images hold fewer than 40 table slots, so both
    return only those slots' rows."""
    names, emb, entries = corpus
    js, ts = _stores(names, emb, entries)
    rng = np.random.default_rng(1)
    queries = np.concatenate([_unit(rng, 6, emb.shape[1]), emb[[0, 7, 13]]])
    want = np.asarray(js.retrieve_fused(jnp.asarray(queries), top_i, top_k))
    got = ts.retrieve_fused(queries, top_i, top_k).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    jsim, jidx = js.search_images(queries, top_i)
    tsim, tidx = ts.search_images(queries, top_i)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(tsim, jsim, atol=1e-6)
    assert all(own not in row for own, row in zip((0, 7, 13), tidx[-3:]))  # own image dropped


def _exact_corpus():
    """Unit vectors of 16 entries ±1/4 (every inner product a multiple of
    1/16, exact in float32), with duplicated rows: 2 = 9 = 17, 4 = 11,
    and 21 an exact copy of the first query."""
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 2, size=(24, 16)) * 2 - 1).astype(np.float32) / 4
    x[9] = x[2]
    x[17] = x[2]
    x[11] = x[4]
    q = (rng.integers(0, 2, size=(5, 16)) * 2 - 1).astype(np.float32) / 4
    q[1] = x[2]  # its duplicates are all self-matches
    q[2] = x[2] * 0.5 + x[4] * 0.5
    q[3] = x[4]
    x[21] = q[0]
    return x, q


@pytest.mark.parametrize("top_i", [1, 2, 3, 5, 8])
def test_ties_keep_the_lower_index_first(top_i):
    """Equal similarities rank by index, at the top-i boundary too, as
    ``jax.lax.top_k``; a store row equal to the query is dropped."""
    x, q = _exact_corpus()
    names = [f"{i}.jpg" for i in range(len(x))]
    entries = _entries(names, [2] * len(x), 16, np.random.default_rng(6))
    js, ts = _stores(names, x, entries)
    jsim, jidx = js.search_images(q, top_i)
    tsim, tidx = ts.search_images(q, top_i)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tsim, jsim)
    assert 21 not in tidx[0] and not np.isin([2, 9, 17], tidx[1]).any()
    for k in (1, 3, 2 * top_i):
        np.testing.assert_array_equal(ts.retrieve_fused(q, top_i, k).numpy(),
                                      np.asarray(js.retrieve_fused(jnp.asarray(q), top_i, k)))


def test_top_images_order_on_plain_ties():
    """``top_images`` alone: constant rows, a tie straddling the boundary,
    -inf entries, and -0 against +0 (XLA ranks by the floats' total order,
    -0 below +0)."""
    inf = float("inf")
    sims = torch.tensor([[0.5, 0.5, 0.5, 0.5, 0.5],
                         [0.1, 0.9, 0.9, 0.3, 0.9],
                         [-inf, 0.2, -inf, -inf, 0.2],
                         [-0.0, 0.0, -0.0, inf, 0.0]])
    for k in (1, 2, 3, 4):
        want_v, want_i = (np.asarray(a) for a in JE.jax.lax.top_k(jnp.asarray(sims.numpy()), k))
        got_v, got_i = TE.top_images(sims, k)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy(), want_v)


def test_similarities_are_float32_without_tf32(corpus):
    names, emb, _ = corpus
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sims = TE.similarities(torch.from_numpy(emb[:3]), torch.from_numpy(emb))
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    want = emb[:3].astype(np.float64) @ emb.T.astype(np.float64)
    want[want > TE.SELF_MATCH_THRESHOLD] = -np.inf
    np.testing.assert_allclose(sims.numpy(), want, atol=1e-6)
    assert sims.dtype == torch.float32 and np.isinf(sims.numpy()[[0, 1, 2], [0, 1, 2]]).all()


def test_host_functions_match_jax(corpus):
    names, emb, entries = corpus
    js, ts = _stores(names, emb, entries)
    q = np.concatenate([emb[:2], _unit(np.random.default_rng(2), 3, emb.shape[1])])
    want = JE.retrieve_images_by_vector_similarity(js, q, 4)
    got = TE.retrieve_images_by_vector_similarity(ts, q, 4)
    assert [[f for f, _ in r] for r in got] == [[f for f, _ in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-6)
    fnames = [[f for f, _ in r] for r in got] + [["not_in_store.jpg", "img_005.jpg"]]
    for top_k in (3, 12):
        np.testing.assert_array_equal(TE.get_caption_embeddings(ts, top_k, fnames),
                                      JE.get_caption_embeddings(js, top_k, fnames))


def test_empty_caption_side_and_cuda_default(corpus):
    names, emb, _ = corpus
    js, ts = _stores(names[:3], emb[:3], [])
    np.testing.assert_array_equal(ts.caption_table.numpy(), np.asarray(js.caption_table))
    np.testing.assert_array_equal(ts.retrieve_fused(emb[3:5], 2, 4).numpy(),
                                  np.asarray(js.retrieve_fused(jnp.asarray(emb[3:5]), 2, 4)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.DeviceVectorStore.build(names[:3], emb[:3], [])
