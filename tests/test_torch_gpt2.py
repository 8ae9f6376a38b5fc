"""The port's GPT-2 against the JAX package's, in float32 at a tiny config:
the prefill logits and cache, and one-token steps through decode attention."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG

CFG_J = JG.GPT2Config.tiny()
CFG_T = TG.GPT2Config.tiny()


def _setup(b=3, p_len=7, extra=6, seed=1):
    params = JG.init(jax.random.PRNGKey(0), CFG_J)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    prefix = np.random.default_rng(seed).normal(size=(b, p_len, CFG_J.n_embd)).astype(np.float32)
    return params, tparams, prefix, p_len + extra


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def test_config_and_cache_layout():
    fields = lambda c: {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}  # noqa: E731
    assert fields(CFG_T) == fields(CFG_J)
    assert TG.GPT2Config.gpt2_124m() == TG.GPT2Config()
    cache = TG.init_cache(CFG_T, 5, 15 + 50, dtype=torch.bfloat16, device="cpu")
    assert cache["k"].shape == (2, 80, 5, 32) and cache["k"].dtype == torch.bfloat16
    assert cache["index"] == 0
    j = JG.init_cache(CFG_J, 5, 65)
    assert tuple(j["k"].shape) == tuple(cache["k"].shape)


@pytest.mark.parametrize("fresh_prefill", [True, False])
def test_prefill_matches_jax(fresh_prefill):
    """The port's prefill of an empty cache against both JAX prefills: the
    prefix attending itself, and the masked walk over the whole cache."""
    params, tparams, prefix, t = _setup()
    want, jcache = JG.forward_cached(
        params, CFG_J, jnp.asarray(prefix), JG.init_cache(CFG_J, 3, t), fresh_prefill=fresh_prefill
    )
    got, tcache = TG.forward_cached(
        tparams, CFG_T, torch.from_numpy(prefix), TG.init_cache(CFG_T, 3, t, device="cpu"),
    )
    _close(got, want)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])
    assert tcache["index"] == int(jcache["index"]) == prefix.shape[1]


def test_one_token_steps_match_jax():
    """Prefill, then three one-token steps (t == 1, decode attention)."""
    params, tparams, prefix, t = _setup(b=4)
    _, jcache = JG.forward_cached(params, CFG_J, jnp.asarray(prefix), JG.init_cache(CFG_J, 4, t))
    _, tcache = TG.forward_cached(tparams, CFG_T, torch.from_numpy(prefix),
                                  TG.init_cache(CFG_T, 4, t, device="cpu"))
    rng = np.random.default_rng(9)
    for _ in range(3):
        tok = rng.normal(size=(4, 1, CFG_J.n_embd)).astype(np.float32)
        want, jcache = JG.forward_cached(params, CFG_J, jnp.asarray(tok), jcache,
                                         use_pallas_decode=False)
        got, tcache = TG.forward_cached(tparams, CFG_T, torch.from_numpy(tok), tcache)
        _close(got, want)
        _close(tcache["k"], jcache["k"])
        assert tcache["index"] == int(jcache["index"])


def test_multi_token_forward_needs_an_empty_cache():
    """Only the prefill of a fresh cache is ported: a second multi-token
    chunk raises instead of attending the cache some other way."""
    _, tparams, prefix, t = _setup(b=2, p_len=4, extra=8)
    _, tcache = TG.forward_cached(tparams, CFG_T, torch.from_numpy(prefix),
                                  TG.init_cache(CFG_T, 2, t, device="cpu"))
    more = np.random.default_rng(3).normal(size=(2, 3, CFG_J.n_embd)).astype(np.float32)
    with pytest.raises(ValueError, match="empty cache"):
        TG.forward_cached(tparams, CFG_T, torch.from_numpy(more), tcache)


def test_embed_tokens_and_init_distributions():
    ids = np.array([[0, 5, 292]], np.int64)
    params, tparams, _, _ = _setup()
    np.testing.assert_array_equal(
        TG.embed_tokens(tparams, torch.from_numpy(ids)).numpy(),
        np.asarray(JG.embed_tokens(params, jnp.asarray(ids))),
    )
    p = TG.init(torch.Generator().manual_seed(0), TG.GPT2Config(vocab_size=500, n_layer=2))
    assert p["blocks"]["attn"]["c_attn"]["w"].shape == (2, 768, 2304)
    assert abs(float(p["wte"].std()) - 0.02) < 1e-3
    assert abs(float(p["wpe"].std()) - 0.01) < 1e-3
    proj_std = 0.02 / 2.0
    assert abs(float(p["blocks"]["mlp"]["c_proj"]["w"].std()) - proj_std) < 1e-3
    assert float(p["blocks"]["attn"]["c_attn"]["b"].abs().max()) == 0.0
