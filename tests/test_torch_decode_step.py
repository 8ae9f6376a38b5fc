"""The port's greedy decode step (its plain twins) against the JAX package's
whole-step Pallas kernel in interpret mode, in float32 at a tiny config."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu_torch.ops import decode_step as TDS

CFG = JG.GPT2Config(vocab_size=293, n_positions=128, n_embd=32, n_layer=2, n_head=2)

# jitted once per shape, so chained steps (idx traced) reuse one compile
_jax_step = jax.jit(
    functools.partial(JDS.fused_decode_step, n_head=CFG.n_head, vocab=CFG.vocab_size,
                      interpret=True)
)


def _torch_params(params):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _prefilled(b, p_len, steps, seed=1):
    params = JG.init(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(seed)
    prefix = jnp.asarray(rng.normal(size=(b, p_len, CFG.n_embd)).astype(np.float32))
    cache = JG.init_cache(CFG, b, p_len + steps + 1)
    logits0, cache = JG.forward_cached(params, CFG, prefix, cache)
    return params, logits0, cache


@pytest.mark.parametrize("b", [5, 8])
def test_plain_step_matches_jax_kernel_over_chained_steps(b):
    """Tokens equal and caches within 1e-6 over 5 chained steps; b = 5 is not
    a multiple of the TPU kernel's 8-row batch tiling."""
    params, logits0, cache = _prefilled(b, p_len=7, steps=5)
    packed_j = JDS.pack_decode_weights(params, compute_dtype=jnp.float32)
    tparams = _torch_params(params)
    packed_t = TDS.pack_decode_weights(tparams, torch.float32)

    kj, vj = cache["k"], cache["v"]
    kt = torch.from_numpy(np.array(kj))
    vt = torch.from_numpy(np.array(vj))
    idx = int(cache["index"])
    tok_j = jnp.argmax(logits0, axis=-1).astype(jnp.int32)
    tok_t = torch.from_numpy(np.array(tok_j))
    for _ in range(5):
        x0_j = params["wte"][tok_j] + params["wpe"][idx]
        tok_j, kj, vj = _jax_step(packed_j, x0_j, kj, vj, jnp.int32(idx))
        x0_t = tparams["wte"][tok_t.long()] + tparams["wpe"][idx]
        tok_t, kt2, vt2 = TDS.fused_decode_step(packed_t, x0_t, kt, vt, idx, n_head=CFG.n_head)
        assert kt2 is kt and vt2 is vt  # appended in place
        assert tok_t.dtype == torch.int32 and tok_t.shape == (b,)
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6, rtol=1e-6)
        idx += 1


def test_argmax_tie_goes_to_first_index():
    """Duplicating the winning token's embedding row at a lower id makes an
    exact tie; both the port and the JAX kernel pick the lower id."""
    b = 3
    params, logits0, cache = _prefilled(b, p_len=5, steps=1, seed=3)
    idx = int(cache["index"])
    tok0 = jnp.argmax(logits0, axis=-1).astype(jnp.int32)
    x0 = params["wte"][tok0] + params["wpe"][idx]
    win, _, _ = _jax_step(
        JDS.pack_decode_weights(params, compute_dtype=jnp.float32), x0, cache["k"], cache["v"],
        jnp.int32(idx),
    )
    w = int(win[0])
    low = 0 if w > 0 else None
    assert low is not None, "pick another seed: row 0's token is already id 0"
    params = dict(params, wte=params["wte"].at[low].set(params["wte"][w]))
    got_j, _, _ = _jax_step(
        JDS.pack_decode_weights(params, compute_dtype=jnp.float32), x0, cache["k"], cache["v"],
        jnp.int32(idx),
    )
    tparams = _torch_params(params)
    got_t, _, _ = TDS.fused_decode_step(
        TDS.pack_decode_weights(tparams, torch.float32), torch.from_numpy(np.array(x0)),
        torch.from_numpy(np.array(cache["k"])), torch.from_numpy(np.array(cache["v"])), idx,
        n_head=CFG.n_head,
    )
    assert int(got_j[0]) == low
    assert int(got_t[0]) == low
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(got_j))


def test_logits_argmax_plain_breaks_ties_to_lowest_id():
    x32 = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    wte = torch.randn(300, 32, generator=torch.Generator().manual_seed(1))
    lnf = torch.stack([torch.ones(32), torch.zeros(32)])
    logits = TDS.logits_plain(x32, lnf, wte)
    top = torch.argmax(logits, dim=-1)
    for low in (0, 37):
        w2 = wte.clone()
        w2[low] = wte[top[1]]
        tok = TDS.logits_argmax_plain(x32, lnf, w2)
        assert int(tok[1]) == min(low, int(top[1]))


def test_pack_decode_weights_layout():
    params = _torch_params(JG.init(jax.random.PRNGKey(0), CFG))
    packed = TDS.pack_decode_weights(params, torch.bfloat16)
    d = CFG.n_embd
    assert packed["qkvw"].shape == (CFG.n_layer, 3 * d, d)
    assert packed["cprojw"].shape == (CFG.n_layer, d, 4 * d)
    assert packed["qkvw"].dtype == torch.bfloat16 and packed["attnb"].dtype == torch.float32
    torch.testing.assert_close(
        packed["fcw"][1].float(), params["blocks"]["mlp"]["c_fc"]["w"][1].t().bfloat16().float()
    )
    assert packed["wte"].shape == (CFG.vocab_size, d) and packed["lnf"].shape == (2, d)


def _jax_mode_step(packed, x0, k, v, idx, **mode):
    return JDS.fused_decode_step(packed, x0, k, v, jnp.int32(idx), n_head=CFG.n_head,
                                 vocab=CFG.vocab_size, interpret=True, **mode)


def _step_inputs(b, p_len, seed):
    params, _, cache = _prefilled(b, p_len=p_len, steps=2, seed=seed)
    x0 = np.random.default_rng(seed + 10).normal(size=(b, CFG.n_embd)).astype(np.float32)
    return params, cache, x0


def test_emit_logits_matches_jax_kernel():
    """emit_logits: the (B, V) float32 logits of the JAX kernel to 1e-5, and
    the same cache append."""
    b = 5
    params, cache, x0 = _step_inputs(b, p_len=6, seed=4)
    idx = int(cache["index"])
    want, kj, vj = _jax_mode_step(JDS.pack_decode_weights(params, compute_dtype=jnp.float32),
                                  jnp.asarray(x0), cache["k"], cache["v"], idx, emit_logits=True)
    kt, vt = (torch.from_numpy(np.array(cache[n])) for n in ("k", "v"))
    got, _, _ = TDS.fused_decode_step(
        TDS.pack_decode_weights(_torch_params(params), torch.float32), torch.from_numpy(x0),
        kt, vt, idx, n_head=CFG.n_head, emit_logits=True,
    )
    assert got.dtype == torch.float32 and got.shape == (b, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 4])
def test_topk_matches_jax_kernel(k):
    """topk=k: ids exactly, values and logsumexp to 1e-5."""
    b = 6
    params, cache, x0 = _step_inputs(b, p_len=3, seed=7)
    idx = int(cache["index"])
    vj, ij, lj, _, _ = _jax_mode_step(JDS.pack_decode_weights(params, compute_dtype=jnp.float32),
                                      jnp.asarray(x0), cache["k"], cache["v"], idx, topk=k)
    vt, it, lt, _, _ = TDS.fused_decode_step(
        TDS.pack_decode_weights(_torch_params(params), torch.float32), torch.from_numpy(x0),
        torch.from_numpy(np.array(cache["k"])), torch.from_numpy(np.array(cache["v"])), idx,
        n_head=CFG.n_head, topk=k,
    )
    assert it.dtype == torch.int32 and it.shape == (b, k) and lt.shape == (b, 1)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)


def test_beam_origin_mode_matches_jax_kernel():
    """Beam mode: a random ancestry map inside each group of k rows, the
    group-identical image prefix read directly (gather_start = p_len), the
    top-k vocabulary walk.  Ids exactly, values and logsumexp to 1e-5; both
    caches equal after the append: every other row untouched, bit for bit,
    and the appended row (this step's projections) to 1e-6."""
    k, n_img, p_len = 4, 4, 9
    bk = n_img * k
    params = JG.init(jax.random.PRNGKey(0), CFG)
    rng = np.random.default_rng(12)
    prefix = np.repeat(rng.normal(size=(n_img, p_len, CFG.n_embd)).astype(np.float32), k, axis=0)
    cache = JG.init_cache(CFG, bk, p_len + 7)
    _, cache = JG.forward_cached(params, CFG, jnp.asarray(prefix), cache)
    extra = rng.normal(size=(bk, 3, CFG.n_embd)).astype(np.float32)  # per-row history
    _, cache = JG.forward_cached(params, CFG, jnp.asarray(extra), cache)
    x0 = rng.normal(size=(bk, CFG.n_embd)).astype(np.float32)
    idx = int(cache["index"])
    tpad = cache["k"].shape[1]
    origin = (np.arange(bk) // k * k)[None, :] + rng.integers(0, k, size=(tpad, bk))
    origin = origin.astype(np.int32)

    vj, ij, lj, kj, vcj = _jax_mode_step(
        JDS.pack_decode_weights(params, compute_dtype=jnp.float32), jnp.asarray(x0),
        cache["k"], cache["v"], idx, origin=jnp.asarray(origin), beam_k=k, topk=k, block_b=8,
        gather_start=p_len,
    )
    kt, vct = (torch.from_numpy(np.array(cache[n])) for n in ("k", "v"))
    vt, it, lt, _, _ = TDS.fused_decode_step(
        TDS.pack_decode_weights(_torch_params(params), torch.float32), torch.from_numpy(x0),
        kt, vct, idx, n_head=CFG.n_head, origin=torch.from_numpy(origin), beam_k=k, topk=k,
        gather_start=p_len,
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)
    for got, want in ((kt.numpy(), np.asarray(kj)), (vct.numpy(), np.asarray(vcj))):
        rest = np.arange(tpad) != idx
        np.testing.assert_array_equal(got[:, rest], want[:, rest])
        np.testing.assert_allclose(got[:, idx], want[:, idx], atol=1e-6, rtol=1e-6)
    # the map mattered: without it the layers' output moves well past 1e-5
    packed = TDS.pack_decode_weights(_torch_params(params), torch.float32)
    outs = [TDS.decode_layers(packed, torch.from_numpy(x0), torch.from_numpy(np.array(cache["k"])),
                              torch.from_numpy(np.array(cache["v"])), idx, n_head=CFG.n_head,
                              **kw)
            for kw in ({}, {"origin": torch.from_numpy(origin), "gather_start": p_len})]
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


def test_step_mode_rules_and_refusals():
    """The JAX function's exclusivity rules; scales with a float cache
    raise (only an int8 cache takes them)."""
    b = 4
    params, cache, x0 = _step_inputs(b, p_len=3, seed=2)
    packed = TDS.pack_decode_weights(_torch_params(params), torch.float32)
    kt, vt = (torch.from_numpy(np.array(cache[n])) for n in ("k", "v"))
    x = torch.from_numpy(x0)
    idx = int(cache["index"])
    origin = torch.zeros((kt.shape[1], b), dtype=torch.int32)
    call = functools.partial(TDS.fused_decode_step, packed, x, kt, vt, idx, n_head=CFG.n_head)
    with pytest.raises(ValueError, match="exclusive"):
        call(topk=2, emit_logits=True)
    with pytest.raises(ValueError, match="origin and beam_k"):
        call(origin=origin)
    with pytest.raises(ValueError, match="beam groups"):
        call(origin=origin, beam_k=3)
    with pytest.raises(ValueError, match="sample mode is exclusive"):
        call(sample={"temp": torch.ones(b), "top_p": torch.ones(b), "seed": 0}, topk=2)
    with pytest.raises(ValueError, match="start and origin are exclusive"):
        call(origin=origin, beam_k=2, start=torch.zeros(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        call(k_scale=torch.ones(1), v_scale=torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        call(emit_logits=True, use_kernels=True)
