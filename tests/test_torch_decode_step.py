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
