"""The step's in-kernel sampler (``sample`` mode) on the port's plain path:
Philox4x32-10 against Random123's known answers, the speculative-accept twin
against the JAX kernel in interpret mode (whose PRNG gives zero bits there,
so the twin is fed zero bits too), the twin's live draws against the exact
renormalised nucleus, and ``generate(sample_in_kernel=True)``'s wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.ops import decode_step as TDS
from gpt2_image_captioning_tpu_torch.ops import sampling as TS

# Random123's known-answer vectors for philox4x32_10 (kat_vectors): counter,
# key, result
KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("case", list(KAT))
def test_philox_matches_random123(case):
    ctr, key, want = KAT[case]
    got = TS.philox4x32_10(torch.tensor([ctr, ctr], dtype=torch.int64), key)
    assert got.dtype == torch.int64
    assert got.tolist() == [list(want), list(want)]


def test_gumbel_of_bits_is_the_tpu_formula():
    bits = torch.tensor([0, 0x7FFFFF, 0xFFFFFFFF, 0x12345678], dtype=torch.int64)
    u = ((bits.numpy() & 0x7FFFFF).astype(np.float64) * 2.0 ** -23 + 2.0 ** -24)
    assert (0 < u).all() and (u < 1).all()
    np.testing.assert_allclose(TS.gumbel_of_bits(bits).numpy(), -np.log(-np.log(u)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the twin with zero bits against the JAX kernel in interpret mode
# (the five cases of tests/test_decode_sample.py:65-172)
# ---------------------------------------------------------------------------

SAMPLE_CASES = {
    # b, vocab, seed, temperatures, top_p, rounds, steps
    "chained_steps": (3, 700, 0, [1.0] * 3, [0.9] * 3, 6, 3),
    "per_row_temperature": (4, 700, 3, [0.0, 1.0, 2.0, 0.5], [0.9] * 4, 6, 1),
    "forced_fallback": (3, 700, 5, [1.0] * 3, [-1.0] * 3, 3, 1),
    "top_p_one": (3, 700, 9, [1.3] * 3, [1.0] * 3, 6, 1),
    "padding_and_multi_tile_vocab": (5, 1100, 11, [1.0] * 5, [0.9] * 5, 6, 1),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_zero_bits_twin_matches_jax_interpret_kernel(case, monkeypatch):
    b, vocab, seed, temps, topps, rounds, steps = SAMPLE_CASES[case]
    cfg = JG.GPT2Config(vocab_size=vocab, n_positions=128, n_embd=32, n_layer=2, n_head=2)
    params = JG.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    prefix = jnp.asarray(rng.normal(size=(b, 5, cfg.n_embd)).astype(np.float32))
    cache = JG.init_cache(cfg, b, 5 + 6)
    logits0, cache = JG.forward_cached(params, cfg, prefix, cache)
    jpacked = JDS.pack_decode_weights(params, compute_dtype=jnp.float32)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    tpacked = TDS.pack_decode_weights(tparams, torch.float32)
    kj, vj = cache["k"], cache["v"]
    kt, vt = (torch.from_numpy(np.array(c)) for c in (kj, vj))
    tok = np.asarray(jnp.argmax(logits0, axis=-1), np.int32)
    idx = int(cache["index"])
    # the interpreter's PRNG gives zero bits; so do these
    monkeypatch.setattr(TS, "philox_words",
                        lambda seed, b, v, r, k, device: torch.zeros(b, v, k, dtype=torch.int64))
    for step in range(steps):
        x0 = np.array(params["wte"][tok] + params["wpe"][idx], np.float32)
        with pltpu.force_tpu_interpret_mode():
            jt, jr, jl, kj, vj = JDS.fused_decode_step(
                jpacked, jnp.asarray(x0), kj, vj, jnp.int32(idx), n_head=2, vocab=vocab,
                sample={"temp": jnp.asarray(temps, jnp.float32),
                        "top_p": jnp.asarray(topps, jnp.float32), "seed": step},
                sample_rounds=rounds)
        tt, tr, tl, kt2, _ = TDS.fused_decode_step(
            tpacked, torch.from_numpy(x0), kt, vt, idx, n_head=2,
            sample={"temp": torch.tensor(temps), "top_p": torch.tensor(topps), "seed": step},
            sample_rounds=rounds)
        assert kt2 is kt and tt.dtype == tr.dtype == torch.int32 and tl.shape == (b, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6, rtol=1e-6)
        tok, idx = tt.numpy(), idx + 1
    if case == "forced_fallback":
        assert (tr.numpy() == rounds + 1).all()
    if case == "per_row_temperature":
        assert tr.tolist() == [0, 1, 1, 1]


def test_sample_mode_is_exclusive_and_checks_its_arguments():
    x = torch.zeros(2, 8)
    kc = torch.zeros(1, 16, 2, 8)
    sample = {"temp": torch.ones(2), "top_p": torch.ones(2), "seed": 0}
    for kw in ({"topk": 2}, {"emit_logits": True},
               {"origin": torch.zeros(16, 2, dtype=torch.int32), "beam_k": 2}):
        with pytest.raises(ValueError, match="exclusive"):
            TDS.fused_decode_step({}, x, kc, kc, 0, n_head=2, sample=sample, **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TDS.logits_sample_cuda(x, torch.zeros(2, 8), torch.zeros(5, 8), torch.ones(2),
                               torch.ones(2), 0)


# ---------------------------------------------------------------------------
# live Philox draws against the exact nucleus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature, top_p", [(1.0, 0.9), (0.7, 0.5), (1.5, 0.95)])
def test_twin_draws_the_renormalised_nucleus(temperature, top_p):
    """4,096 rows of one fixed logit vector, each drawing with its own Philox
    counters: every token lies in the nucleus (the mass strictly above it is
    <= top_p), the draws are within TV 0.08 of the renormalised nucleus (the
    sampling spread of 4,096 exact draws over these 5-72 kept tokens is
    0.01-0.05, at most 0.06 in 20 trials), and the share of rows that needed
    a second round is at most (1 - top_p)^k, plus 0.02 of spread."""
    n, d, v, k = 4096, 16, 96, 3
    g = torch.Generator().manual_seed(1)
    wte = 0.35 * torch.randn(v, d, generator=g)
    lnf = torch.stack([torch.ones(d), torch.zeros(d)])
    x32 = torch.randn(1, d, generator=g).expand(n, d).contiguous()
    temp = torch.full((n,), temperature)
    tok, rnd, lse = TS.sample_step_plain(x32, lnf, wte, temp, torch.full((n,), top_p),
                                         seed=123, k=k, rounds=6)
    lq = TDS.logits_plain(x32[:1], lnf, wte)[0].double() / temperature
    prob = torch.softmax(lq, dim=0)
    above = torch.stack([prob[lq > lq[t]].sum() for t in range(v)])
    kept = above <= top_p
    assert kept.sum() >= 5 and bool(kept[tok.long()].all())
    want = torch.where(kept, prob, 0.0)
    want /= want.sum()
    got = torch.bincount(tok.long(), minlength=v).double() / n
    tv = 0.5 * float((got - want).abs().sum())
    assert tv < 0.08, tv
    assert int((rnd == 0).sum()) == 0
    assert float((rnd > 1).double().mean()) <= (1 - top_p) ** k + 0.02
    torch.testing.assert_close(lse[0, 0].double(), torch.logsumexp(lq, 0), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# generate(sample_in_kernel=True)
# ---------------------------------------------------------------------------

def _tiny_model():
    cfg = TC.CaptionerConfig(
        gpt2=TG.GPT2Config(vocab_size=311, n_positions=64, n_embd=32, n_layer=2, n_head=2),
        mapping=TM.TransformerMappingConfig(16, 32, prefix_length=3, hidden_length=2),
        eos_token_id=310)
    tr, fz = TC.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    emb = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32))
    return cfg, tr, fz, emb


def test_generate_sample_in_kernel_wiring(monkeypatch):
    """With zero bits every in-step draw is the argmax, so the tokens are the
    first token of the eager draw (the same generator seed as the logits
    tail's) followed by the greedy continuation, EOS-padded; with live bits
    the tokens are drawn, and repeat for a repeated seed."""
    cfg, tr, fz, emb = _tiny_model()
    kw = dict(max_length=6, temperature=1.0, top_p=0.9)

    def gen():
        return torch.Generator().manual_seed(11)

    live = TC.generate(tr, fz, cfg, emb, generator=gen(), sample_in_kernel=True, **kw)
    torch.testing.assert_close(
        TC.generate(tr, fz, cfg, emb, generator=gen(), sample_in_kernel=True, **kw), live,
        rtol=0, atol=0)
    tail = TC.generate(tr, fz, cfg, emb, generator=gen(), **kw)
    torch.testing.assert_close(live[:, 0], tail[:, 0], rtol=0, atol=0)
    monkeypatch.setattr(TS, "philox_words",
                        lambda seed, b, v, r, k, device: torch.zeros(b, v, k, dtype=torch.int64))
    got = TC.generate(tr, fz, cfg, emb, generator=gen(), sample_in_kernel=True, **kw).numpy()
    assert not np.array_equal(got, live.numpy())
    gp = TC._gpt(tr, fz)
    prefix = TC.build_prefix(tr, cfg, emb)
    cache = TG.init_cache(cfg.gpt2, 4, prefix.shape[1] + 6, device="cpu")
    _, cache = TG.forward_cached(gp, cfg.gpt2, prefix, cache)
    want = np.full((4, 6), cfg.eos_token_id, np.int32)
    want[:, 0] = tail[:, 0].numpy()
    tok, finished = tail[:, :1].long(), want[:, 0] == cfg.eos_token_id
    for step in range(1, 6):
        logits, cache = TG.forward_cached(gp, cfg.gpt2, TG.embed_tokens(gp, tok), cache)
        nxt = logits.argmax(-1).numpy()
        finished |= nxt == cfg.eos_token_id
        want[:, step] = np.where(finished, cfg.eos_token_id, nxt)
        tok = torch.from_numpy(want[:, step : step + 1]).long()
    np.testing.assert_array_equal(got, want)


def test_generate_sample_in_kernel_below_half_warns_and_uses_the_tail():
    cfg, tr, fz, emb = _tiny_model()
    kw = dict(max_length=6, temperature=1.0, top_p=0.3)
    with pytest.warns(UserWarning, match="top_p >= 0.5"):
        got = TC.generate(tr, fz, cfg, emb, generator=torch.Generator().manual_seed(4),
                          sample_in_kernel=True, **kw)
    want = TC.generate(tr, fz, cfg, emb, generator=torch.Generator().manual_seed(4), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
