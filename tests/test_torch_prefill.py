"""The port's GPT-2 prefill (``ops/prefill_step.py``: the plain twin of
``csrc/prefill.cu``) against the JAX package's: its Pallas ``fused_prefill``
/ ``prefill_into_cache`` in interpret mode and its ``forward_cached``
prefill, in float32 at the JAX test's own bounds (logits 2e-4, cache 1e-4),
and in bf16; and the captioner's entry points, which now prefill through it,
against the JAX package's tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.precision import BF16 as JBF16
from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu.ops import prefill_step as JPS
from gpt2_image_captioning_tpu_torch.core.precision import BF16, F32, cast_floating
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.ops import decode_step as TDS
from gpt2_image_captioning_tpu_torch.ops import prefill_step as TPS

GCFG = dict(vocab_size=293, n_positions=128, n_embd=32, n_layer=2, n_head=2)


def _setup(b, p_len, seed=0):
    cfg = JG.GPT2Config(**GCFG)
    params = JG.init(jax.random.PRNGKey(seed), cfg)
    prefix = np.random.default_rng(seed + 1).normal(size=(b, p_len, 32)).astype(np.float32)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return cfg, TG.GPT2Config(**GCFG), params, tparams, prefix


def _port_prefill(tcfg, tparams, prefix, policy=F32, extra=6):
    b, p_len, _ = prefix.shape
    cdt = policy.compute_dtype
    gp = cast_floating(tparams, cdt) if cdt != torch.float32 else tparams
    packed = TDS.pack_decode_weights(gp, cdt)
    cache = TG.init_cache(tcfg, b, p_len + extra, dtype=cdt, device="cpu")
    return TPS.prefill_into_cache(packed, gp, tcfg, torch.from_numpy(prefix), cache, policy)


def _assert_prefill_close(got_logits, got_cache, want_logits, want_k, want_v, p_len,
                          tol_logits=2e-4, tol_cache=1e-4):
    np.testing.assert_allclose(got_logits.float().numpy(), np.asarray(want_logits, np.float32),
                               atol=tol_logits, rtol=tol_logits)
    for got, want in ((got_cache["k"], want_k), (got_cache["v"], want_v)):
        np.testing.assert_allclose(got[:, :p_len].float().numpy(),
                                   np.asarray(want[:, :p_len], np.float32),
                                   atol=tol_cache, rtol=tol_cache)
        assert not got[:, p_len:].any()  # rows past the prefix stay zero
    assert got_cache["index"] == p_len


@pytest.mark.parametrize("b, p_len", [(3, 7), (2, 15)])
def test_prefill_matches_jax_fused_prefill_interpret(b, p_len):
    """Logits and every written cache row equal the JAX Pallas prefill's."""
    cfg, tcfg, params, tparams, prefix = _setup(b, p_len)
    packed = JDS.pack_decode_weights(params, compute_dtype=jnp.float32)
    want_logits, want_cache = JPS.prefill_into_cache(
        packed, params, cfg, jnp.asarray(prefix), JG.init_cache(cfg, b, p_len + 6), JF32,
        interpret=True)
    got_logits, got_cache = _port_prefill(tcfg, tparams, prefix)
    _assert_prefill_close(got_logits, got_cache, want_logits, want_cache["k"],
                          want_cache["v"], p_len)


@pytest.mark.parametrize("p_len", [1, 2, 10])
def test_prefill_matches_forward_cached(p_len):
    """Short and odd prefixes against the JAX ``forward_cached`` prefill (the
    JAX prefill test's oracle), at its bounds."""
    cfg, tcfg, params, tparams, prefix = _setup(2, p_len)
    want_logits, want_cache = JG.forward_cached(
        params, cfg, jnp.asarray(prefix), JG.init_cache(cfg, 2, p_len + 6), fresh_prefill=True)
    got_logits, got_cache = _port_prefill(tcfg, tparams, prefix)
    _assert_prefill_close(got_logits, got_cache, want_logits, want_cache["k"],
                          want_cache["v"], p_len)


def test_prefill_bf16_matches_jax_bf16():
    """bf16, against the JAX ``forward_cached`` prefill in bf16 on the same
    weights.  The two round differently (the port keeps the residual stream
    in float32 across layers, as the TPU kernel does; the JAX layerwise path
    rounds it to bf16 after each block), each within a few bf16 ulps (2^-8
    relative) of the exact value over 2 layers.  Measured: logits (|max|
    0.34) 1.5e-3 apart, held to 5e-3; cache rows (|max| 0.42) one ulp,
    2e-3, apart, held to 1e-2 (a ulp or two of values up to ~1)."""
    cfg, tcfg, params, tparams, prefix = _setup(3, 7, seed=4)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    want_logits, want_cache = JG.forward_cached(
        jp, cfg, jnp.asarray(prefix), JG.init_cache(cfg, 3, 13, dtype=jnp.bfloat16), JBF16,
        fresh_prefill=True)
    got_logits, got_cache = _port_prefill(tcfg, tparams, prefix, BF16)
    assert got_cache["k"].dtype == torch.bfloat16
    _assert_prefill_close(got_logits, got_cache, want_logits, want_cache["k"],
                          want_cache["v"], 7, tol_logits=5e-3, tol_cache=1e-2)


def test_prefill_refusals():
    """Prefixes beyond the kernel's 32 tokens, an int8 pack, a fresh cache
    only; the CUDA wrapper refuses CPU tensors."""
    _, tcfg, _, tparams, prefix = _setup(1, 33)
    packed = TDS.pack_decode_weights(tparams, torch.float32)
    x0 = torch.from_numpy(prefix)
    cache = TG.init_cache(tcfg, 1, 40, device="cpu")
    with pytest.raises(ValueError, match="1 to 32 tokens"):
        TPS.prefill_plain(packed, x0, cache["k"], cache["v"], n_head=2)
    with pytest.raises(ValueError, match="float decode pack"):
        TPS.prefill_plain(TDS.pack_decode_weights(tparams, quant=True), x0[:, :4], cache["k"],
                          cache["v"], n_head=2)
    with pytest.raises(ValueError, match="1 to 32 tokens"):
        TPS.prefill_cuda(packed, x0, cache["k"], cache["v"], n_head=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TPS.prefill_cuda(packed, x0[:, :4], cache["k"], cache["v"], n_head=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TPS.fused_prefill(packed, x0[:, :4], cache["k"], cache["v"], n_head=2, use_kernel=True)
    cache["index"] = 3
    with pytest.raises(ValueError, match="fresh cache"):
        TPS.prefill_into_cache(packed, tparams, tcfg, x0[:, :4], cache, F32)


def _models(prefix_length=3, seed=3):
    kw = dict(vocab_size=293, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**kw), mapping=JM.MLPMappingConfig(
        prefix_length=prefix_length, embed_dim=16, gpt_dim=32), eos_token_id=292)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**kw), mapping=TM.MLPMappingConfig(
        prefix_length=prefix_length, embed_dim=16, gpt_dim=32), eos_token_id=292)
    tr, fz = JC.init_params(jax.random.PRNGKey(seed), jcfg)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return jcfg, tcfg, tr, fz, ttr, tfz


def test_entry_points_prefill_through_the_kernel_path(monkeypatch):
    """``generate``, ``beam_generate`` (B unique rows prefilled once) and
    ``admit_prefill`` run the prefill (its twin on the CPU) and give the JAX
    package's tokens in float32; an int8 decode keeps ``forward_cached``."""
    jcfg, tcfg, tr, fz, ttr, tfz = _models()
    emb = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)
    rows = []
    real = TPS.prefill_plain

    def counted(packed, x0, *a, **kw):
        rows.append(x0.shape[0])
        return real(packed, x0, *a, **kw)

    monkeypatch.setattr(TPS, "prefill_plain", counted)
    want = np.asarray(JC.generate(tr, fz, jcfg, jnp.asarray(emb), max_length=8, temperature=0.0,
                                  use_pallas_decode=False))
    got = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    want_beam = np.asarray(JC.beam_generate(tr, fz, jcfg, jnp.asarray(emb), max_length=8,
                                            beam_size=3, use_pallas_decode=False))
    got_beam = TC.beam_generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=8, beam_size=3)
    np.testing.assert_array_equal(got_beam.numpy(), want_beam)
    assert rows == [4, 4]  # the beam search prefilled its 4 images, not 12 beams

    shape = (2, 16, 5, 32)
    k, v = torch.zeros(shape), torch.zeros(shape)
    sel = torch.tensor([3, 0], dtype=torch.int32)
    logits, k, v = TC.admit_prefill(ttr, tfz, tcfg, torch.from_numpy(emb[:2]), k, v, 6, sel,
                                    torch.tensor([True, True]),
                                    packed=TC.prepare_decode_weights(ttr, tfz, tcfg, F32))
    assert rows == [4, 4, 2]
    first, jk, _ = JC.admit_prefill(tr, fz, jcfg, jnp.asarray(emb[:2]), jnp.zeros(shape),
                                    jnp.zeros(shape), jnp.int32(6), jnp.asarray(sel),
                                    jnp.asarray([True, True]), policy=JF32)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(first))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)

    TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=4, temperature=0.0,
                decode_quant=True)
    assert rows == [4, 4, 2]  # the int8 decode prefilled with forward_cached


def test_long_prefix_is_refused_not_handed_over():
    """A 33-token prefix is beyond the prefill kernel's range: ``generate``,
    ``beam_generate`` and ``admit_prefill`` raise from the prefill rather
    than prefilling another way; an int8 decode keeps ``forward_cached``."""
    _, tcfg, _, _, ttr, tfz = _models(prefix_length=33)
    emb = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 16)).astype(np.float32))
    packed = TC.prepare_decode_weights(ttr, tfz, tcfg, F32)
    shape = (2, 48, 2, 32)
    calls = (
        lambda: TC.generate(ttr, tfz, tcfg, emb, max_length=4, temperature=0.0),
        lambda: TC.beam_generate(ttr, tfz, tcfg, emb, max_length=4, beam_size=2),
        lambda: TC.admit_prefill(ttr, tfz, tcfg, emb, torch.zeros(shape), torch.zeros(shape),
                                 40, torch.tensor([0, 1]), torch.tensor([True, True]),
                                 packed=packed),
    )
    for call in calls:
        with pytest.raises(ValueError, match="1 to 32 tokens"):
            call()
    toks = TC.generate(ttr, tfz, tcfg, emb, max_length=4, temperature=0.0, decode_quant=True)
    assert toks.shape == (2, 4)
