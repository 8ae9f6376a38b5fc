"""The port's token selection (``ops/sampling.py``) against the JAX package's,
on logits made from a seed with numpy: the nucleus masks and the top-k
exactly, the draws in distribution (torch's generator is not jax.random).

Tolerances: masks, indices and kept values exactly; the sampling
distribution to a total-variation distance of 0.02 over 20,000 draws on a
vocabulary of 32 (the expected distance of an exact sampler there is about
0.01).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.ops import sampling as JS
from gpt2_image_captioning_tpu_torch.ops import sampling as TS


def _logits(b=6, v=257, scale=3.0, seed=0):
    return (scale * np.random.default_rng(seed).normal(size=(b, v))).astype(np.float32)


def _masks(got: torch.Tensor, want) -> tuple[np.ndarray, np.ndarray]:
    return got.numpy() == TS.NEG_INF, np.asarray(want) == float(JS.NEG_INF)


FILTERS = {
    "sort": (lambda x, p: TS.top_p_filter(x, p), lambda x, p: JS.top_p_filter(x, p)),
    "bisect_ways2": (lambda x, p: TS.top_p_filter_bisect(x, p),
                     lambda x, p: JS.top_p_filter_bisect(x, p)),
    "bisect_ways4": (lambda x, p: TS.top_p_filter_bisect(x, p, ways=4),
                     lambda x, p: JS.top_p_filter_bisect(x, p, ways=4)),
}


# the sorted filter takes a scalar top_p, as the JAX package's does
CASES = [(name, False) for name in FILTERS] + [("bisect_ways2", True), ("bisect_ways4", True)]


@pytest.mark.parametrize("name,per_row", CASES,
                         ids=[f"{n}-{'per_row' if r else 'scalar'}" for n, r in CASES])
def test_top_p_masks_match_jax(name, per_row):
    x = _logits()
    top_p = np.array([[0.5], [0.9], [0.99], [0.1], [1.0], [0.75]], np.float32) if per_row else 0.9
    fn_t, fn_j = FILTERS[name]
    got = fn_t(torch.from_numpy(x), torch.from_numpy(top_p) if per_row else top_p)
    want = fn_j(jnp.asarray(x), jnp.asarray(top_p) if per_row else top_p)
    got_mask, want_mask = _masks(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    np.testing.assert_array_equal(got.numpy()[~got_mask], x[~got_mask])
    kept = (~got_mask).sum(axis=1)
    assert (kept >= 1).all() and (kept < x.shape[1]).any()
    if per_row:
        assert kept[4] == x.shape[1]  # top_p 1 keeps the whole row


def test_bisect_equals_sort_mask():
    """Away from exact ties the bisection finds the sorted path's kept set."""
    x = torch.from_numpy(_logits(seed=4))
    a, b = TS.top_p_filter(x, 0.8), TS.top_p_filter_bisect(x, 0.8)
    np.testing.assert_array_equal(a.numpy() == TS.NEG_INF, b.numpy() == TS.NEG_INF)


@pytest.mark.parametrize("ways", [2, 4])
def test_peaked_row_keeps_exactly_its_top1(ways):
    """A row whose top-1 holds nearly all the mass keeps exactly that token,
    never an empty set: a one-ulp slip of the bisection lands its bracket
    on the row max, so the top-1 is kept explicitly."""
    x = _logits(b=4, v=101, scale=1.0, seed=2)
    top = x.argmax(axis=1)
    x[np.arange(4), top] = 60.0
    for top_p in (0.9, 1e-6):
        got = TS.top_p_filter_bisect(torch.from_numpy(x), top_p, ways=ways).numpy()
        want = np.asarray(JS.top_p_filter_bisect(jnp.asarray(x), top_p, ways=ways))
        kept = got != TS.NEG_INF
        np.testing.assert_array_equal(kept, want != float(JS.NEG_INF))
        np.testing.assert_array_equal(kept.sum(axis=1), np.ones(4))
        np.testing.assert_array_equal(kept.argmax(axis=1), top)


def test_topk_small_matches_jax_with_ties_and_neg_inf_entries():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    x[0, [2, 7, 11]] = 4.0  # a three-way tie for the top: ids in order
    x[1, [0, 15]] = 3.5
    x[2, :] = float(JS.NEG_INF)  # dead-beam scores: four distinct ids still
    x[2, 9] = 0.5
    x[3, [4, 5]] = float(JS.NEG_INF)
    for k in (1, 4):
        vals, ids = TS.topk_small(torch.from_numpy(x), k)
        want_v, want_i = JS.topk_small(jnp.asarray(x), k)
        assert ids.dtype == torch.int32 and ids.shape == (5, k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert ids[0, :3].tolist() == [2, 7, 11]
    assert len(set(ids[2].tolist())) == 4 and ids[2, 0] == 9


def test_sample_token_at_temperature_zero_is_the_argmax():
    x = _logits(seed=5)
    x[1, [3, 8]] = 100.0  # a tie goes to the first index
    got = TS.sample_token(torch.from_numpy(x), temperature=0.0, top_p=0.9, generator=None)
    want = JS.sample_token(jnp.asarray(x), temperature=0.0, top_p=0.9, rng=None)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 3


@pytest.mark.parametrize("sort", [False, True], ids=["bisect", "sort"])
def test_draws_lie_in_the_jax_nucleus_with_its_distribution(sort):
    """20,000 draws at T = 1, top_p = 0.9 from one row of 32 logits: every
    draw is in the JAX package's keep-set, and the draws' histogram is within
    a total-variation distance of 0.02 of the renormalised nucleus — through
    ``sample_token`` (the bisection mask) and through the sorted mask drawn
    from by ``gumbel_argmax``."""
    n, v = 20_000, 32
    row = (1.5 * np.random.default_rng(6).normal(size=(1, v))).astype(np.float32)
    keep = np.asarray(JS.top_p_filter(jnp.asarray(row), 0.9))[0] != float(JS.NEG_INF)
    assert 2 < keep.sum() < v
    g = torch.Generator().manual_seed(123)
    x = torch.from_numpy(np.repeat(row, n, axis=0))
    if sort:
        draws = TS.gumbel_argmax(TS.top_p_filter(x, 0.9), g).numpy()
    else:
        draws = TS.sample_token(x, temperature=1.0, top_p=0.9, generator=g).numpy()
    assert keep[draws].all()
    p = np.where(keep, np.exp(row[0] - row[0].max()), 0.0)
    p /= p.sum()
    tv = 0.5 * np.abs(np.bincount(draws, minlength=v) / n - p).sum()
    assert tv < 0.02, tv


def test_same_generator_seed_gives_the_same_draws():
    x = torch.from_numpy(_logits(b=64, seed=7))
    a = TS.sample_token(x, temperature=0.8, top_p=0.9, generator=torch.Generator().manual_seed(9))
    b = TS.sample_token(x, temperature=0.8, top_p=0.9, generator=torch.Generator().manual_seed(9))
    c = TS.sample_token(x, temperature=0.8, top_p=0.9, generator=torch.Generator().manual_seed(10))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = TS.top_p_filter_bisect(x / 0.8, 0.9) != TS.NEG_INF
    assert kept.gather(1, a.long()[:, None]).all()
