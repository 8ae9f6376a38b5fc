"""The port's int8 decode (W8A8 weights, the int8 KV cache) against the JAX
package's, in float32 at a tiny config (2 layers, width 32, 2 heads, vocab
293): the quantizers against the JAX formulas, every vocabulary mode of the
int8 step against the JAX step kernel in interpret mode, and the int8 entry
points (``generate``, ``beam_generate``, ``ImageCaptioningModel``,
``ContinuousCaptionService``) against the JAX ones, token for token.  The
port runs its plain twins here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.ops import decode_attention as TDA
from gpt2_image_captioning_tpu_torch.ops import decode_step as TDS
from gpt2_image_captioning_tpu_torch.ops import quant as TQ
from gpt2_image_captioning_tpu_torch.ops import sampling as TS
from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService

GCFG = dict(vocab_size=293, n_positions=128, n_embd=32, n_layer=2, n_head=2)
CFG = JG.GPT2Config(**GCFG)
# logits of the int8 step against the JAX kernel's: 1e-4 of the largest |logit|
LOGIT_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_step(packed, x0, k, v, idx, **mode):
    return JDS.fused_decode_step(packed, jnp.asarray(x0), k, v, jnp.int32(idx), n_head=CFG.n_head,
                                 vocab=CFG.vocab_size, interpret=True, **mode)


def _packs(seed=0):
    """The same weights as the JAX int8 pack and the port's."""
    params = JG.init(jax.random.PRNGKey(seed), CFG)
    jpacked = JDS.pack_decode_weights(params, compute_dtype=jnp.float32, quant=True)
    tparams = jax.tree.map(_t, params)
    return params, jpacked, tparams, TDS.pack_decode_weights(tparams, torch.float32, quant=True)


def _prefilled(params, b, p_len, extra=4, seed=1):
    rng = np.random.default_rng(seed)
    prefix = jnp.asarray(rng.normal(size=(b, p_len, CFG.n_embd)).astype(np.float32))
    cache = JG.init_cache(CFG, b, p_len + extra)
    _, cache = JG.forward_cached(params, CFG, prefix, cache)
    x0 = rng.normal(size=(b, CFG.n_embd)).astype(np.float32)
    return cache, x0


def _assert_logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=LOGIT_RTOL * float(np.abs(want).max()))


def _assert_colquant_equal(q, s, jq, js, w):
    """int8 equal, scales within one float32 ulp; an element whose |w/s| lies
    within 1e-6 of a half-integer may differ by one step."""
    jq, js = np.asarray(jq), np.asarray(js)
    np.testing.assert_array_max_ulp(s.numpy(), js, maxulp=1)
    ratio = np.abs(np.asarray(w, np.float64) / np.expand_dims(js.astype(np.float64), -2))
    near_half = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-6
    diff = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
    assert (diff[~near_half] == 0).all() and (diff <= 1).all()


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 96), (2, 128, 32), (1, 32, 293)],
                         ids=["qkv", "mlp_proj", "wte"])
def test_colquant_matches_jax(shape):
    """Per-output-column weights, on the same float32 values as ``_colquant``
    (the wte case as the JAX pack treats it: (1, D, V), a column per token)."""
    w = np.random.default_rng(sum(shape)).normal(scale=0.02, size=shape).astype(np.float32)
    w[0, :, 0] = 0.0  # an all-zero column: scale 1e-12, int8 zeros
    jq, js = JDS._colquant(jnp.asarray(w))
    q, s = TQ.colquant(torch.from_numpy(w))
    assert q.dtype == torch.int8 and q.shape == shape and s.shape == (shape[0], shape[2])
    _assert_colquant_equal(q, s, jq, js, w)
    assert float(s[0, 0]) == np.float32(1e-12) and not q[0, :, 0].any()


def test_int8_pack_matches_the_jax_pack():
    """The port's int8 pack holds ``_colquant``'s values in its output-major
    layout: (L, N, K) int8 with (L, N) scales, wte (V, D) with (V,)."""
    params, _, tparams, packed = _packs()
    d, v = CFG.n_embd, CFG.vocab_size
    blocks = params["blocks"]
    for role, w in (("qkv", blocks["attn"]["c_attn"]["w"]), ("proj", blocks["attn"]["c_proj"]["w"]),
                    ("fc", blocks["mlp"]["c_fc"]["w"]), ("cproj", blocks["mlp"]["c_proj"]["w"])):
        jq, js = JDS._colquant(w.astype(jnp.float32))
        q, s = packed[role + "w"], packed[role + "s"]
        assert q.dtype == torch.int8 and q.shape == (CFG.n_layer, w.shape[2], w.shape[1])
        _assert_colquant_equal(q.transpose(1, 2), s, jq, js, w)
    jq, js = JDS._colquant(params["wte"].astype(jnp.float32).T[None])
    assert packed["wte"].shape == (v, d) and packed["wtes"].shape == (v,)
    _assert_colquant_equal(packed["wte"].t()[None], packed["wtes"][None], jq, js,
                           np.asarray(params["wte"]).T[None])
    assert packed["attnb"].dtype == torch.float32 and "qkvs" not in TDS.pack_decode_weights(
        tparams, torch.float32)


def test_quantize_cache_matches_jax():
    """Every row of the caches, the all-zero rows past the prefill included
    (scale 1e-12, int8 zeros): int8 equal, scales within one ulp."""
    params = JG.init(jax.random.PRNGKey(0), CFG)
    cache, _ = _prefilled(params, b=3, p_len=5, extra=6)
    jkq, jvq, jks, jvs = JDS.quantize_cache(cache["k"], cache["v"])
    kq, vq, ks, vs = TDS.quantize_cache(_t(cache["k"]), _t(cache["v"]))
    for got, want in ((kq, jkq), (vq, jvq)):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((ks, jks), (vs, jvs)):
        assert got.shape == cache["k"].shape[:3]
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)
    assert (ks[:, 5:].numpy() == np.float32(1e-12)).all() and not kq[:, 5:].any()


def _jax_rowquant(x_in):
    """The step kernel's ``rowquant`` (decode_step.py:234-240), verbatim."""
    xf = x_in.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=1, keepdims=True) * (1.0 / 127.0), 1e-12)
    return jnp.round(xf / sx).astype(jnp.int8), sx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_ln", [False, True], ids=["plain", "ln"])
def test_rowquant_plain_matches_the_step_formula(with_ln, dtype):
    """Without LN, rows already in the compute dtype; with it, float32 rows
    LayerNorm'd and rounded to the compute dtype first (decode_step.py:530,
    :553), as the step does before quantizing."""
    rng = np.random.default_rng(3)
    x = (3.0 * rng.normal(size=(6, 96))).astype(np.float32)
    x[1] = 0.0  # an all-zero row (scale 1e-12 and int8 zeros without the LN)
    scale = (1 + 0.1 * rng.normal(size=96)).astype(np.float32)
    bias = (0.1 * rng.normal(size=96)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if with_ln:
        xin = JDS._ln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5).astype(jdt)
        q, s = TQ.rowquant_plain(torch.from_numpy(x), (_t(scale), _t(bias)), 1e-5, tdt)
    else:
        xin = jnp.asarray(x).astype(jdt)
        q, s = TQ.rowquant_plain(torch.from_numpy(x).to(tdt))
    jq, js = _jax_rowquant(xin)
    assert q.dtype == torch.int8 and s.shape == (6, 1) and s.dtype == torch.float32
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01  # LN summation order flips at most
    if not with_ln:
        assert diff.max() == 0
        assert float(s[1]) == np.float32(1e-12) and not q[1].any()


@pytest.mark.parametrize("rows", [0, 128, 512], ids=["unsplit", "plan_b128", "plan_b512"])
def test_int8_accumulation_stays_exact_at_k3072(rows):
    """±127 operands over K = 3072 (the MLP down-projection): the twin's
    products equal the exact integer sums, which float32 accumulation would
    round (3072 * 127^2 > 2^24).  With ``rows``, also the int8 kernel's K
    split at that batch (``linear_plan``): the int32 partial sums over its
    K-slices, added in any order, give the unsplit result bit for bit, so
    the cluster's reduction cannot move an int8 output."""
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.choice([-127, 127], size=(4, 3072)).astype(np.int8))
    wq = torch.from_numpy(rng.choice([-127, 126, 127], size=(5, 3072)).astype(np.int8))
    xq[0] = 127
    wq[0] = 127  # the largest sum, 3072 * 127^2 = 49,548,288
    exact = xq.long() @ wq.long().t()
    ones = torch.ones(4, 1)
    got = TQ.int8_matmul(xq, ones, wq, torch.ones(5))
    np.testing.assert_array_equal(got.double().numpy(), exact.double().numpy().astype(np.float32))
    assert int(exact[0, 0]) == 3072 * 127 * 127
    f32 = xq.float() @ wq.float().t()
    assert not torch.equal(f32.double(), exact.double())  # float32 rounds some sums
    if not rows:
        return
    plan = TDS.linear_plan(rows, 3072, 768, 1)
    assert plan.splits > 1
    ks = plan.k_slice
    parts = [(xq[:, i * ks:(i + 1) * ks].long() @ wq[:, i * ks:(i + 1) * ks].long().t())
             for i in range(plan.splits)]
    assert all(int(p.abs().max()) < 2 ** 31 for p in parts)  # each fits the int32 accumulator
    sx, sw = torch.full((4, 1), 0.0123), torch.full((5,), 0.0071)
    want = TQ.int8_matmul(xq, sx, wq, sw)
    for order in (range(plan.splits), reversed(range(plan.splits)),
                  rng.permutation(plan.splits)):
        acc = torch.zeros(4, 5, dtype=torch.int32)
        for i in order:
            acc += parts[int(i)].to(torch.int32)
        assert torch.equal(acc.float() * sx * sw, want)


# ---------------------------------------------------------------------------
# the int8 step in every vocabulary mode against the JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["emit_logits", "greedy", "topk_origin", "start"])
def test_w8a8_step_matches_jax_kernel(mode):
    """The W8A8 step: logits to 1e-4 of the largest |logit|, greedy and top-k
    ids equal, the cache appended alike."""
    params, jpacked, tparams, tpacked = _packs()
    k_beam, p_len = 4, 6
    b = 8 if mode == "topk_origin" else 5
    cache, x0 = _prefilled(params, b, p_len)
    jmode, tmode = {}, {}
    idx = int(cache["index"])
    if mode == "topk_origin":
        # as beam search has them: each group's image prefix shared (read
        # directly below gather_start), then a history of its own per row
        rng = np.random.default_rng(4)
        prefix = np.repeat(rng.normal(size=(b // k_beam, p_len, CFG.n_embd)), k_beam, axis=0)
        cache = JG.init_cache(CFG, b, p_len + 7)
        _, cache = JG.forward_cached(params, CFG, jnp.asarray(prefix, jnp.float32), cache)
        extra = rng.normal(size=(b, 3, CFG.n_embd)).astype(np.float32)
        _, cache = JG.forward_cached(params, CFG, jnp.asarray(extra), cache)
        tpad = cache["k"].shape[1]
        origin = ((np.arange(b) // k_beam * k_beam)[None, :]
                  + rng.integers(0, k_beam, size=(tpad, b))).astype(np.int32)
        jmode = dict(topk=k_beam, origin=jnp.asarray(origin), beam_k=k_beam, block_b=8,
                     gather_start=p_len)
        tmode = dict(topk=k_beam, origin=_t(origin), beam_k=k_beam, gather_start=p_len)
        idx = int(cache["index"])
    elif mode == "start":
        start = np.array([0, 1, 3, 5, idx], np.int32)
        jmode = dict(emit_logits=True, start=jnp.asarray(start))
        tmode = dict(emit_logits=True, start=_t(start))
    elif mode == "emit_logits":
        jmode = tmode = dict(emit_logits=True)
    want = _jax_step(jpacked, x0, cache["k"], cache["v"], idx, **jmode)
    kt, vt = _t(cache["k"]), _t(cache["v"])
    got = TDS.fused_decode_step(tpacked, torch.from_numpy(x0), kt, vt, idx, n_head=CFG.n_head,
                                **tmode)
    if mode == "topk_origin":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _assert_logits_close(got[0].numpy(), want[0])
        _assert_logits_close(got[2].numpy(), want[2])
    elif mode == "greedy":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        logits = _jax_step(jpacked, x0, cache["k"], cache["v"], idx, emit_logits=True)[0]
        assert (np.asarray(logits).argmax(-1) == got[0].numpy()).all()
    else:
        assert got[0].shape == (b, CFG.vocab_size)
        _assert_logits_close(got[0].numpy(), want[0])
    np.testing.assert_allclose(kt.numpy(), np.asarray(want[-2]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(want[-1]), atol=1e-6, rtol=1e-6)


def test_w8a8_sample_step_matches_jax_kernel_with_zero_bits(monkeypatch):
    """The in-kernel draw on the int8 logits, fed zero bits as the JAX
    interpreter's PRNG gives: tokens and rounds equal, logsumexp close."""
    params, jpacked, _, tpacked = _packs(seed=3)
    b = 4
    cache, x0 = _prefilled(params, b, p_len=5, seed=6)
    idx = int(cache["index"])
    temps, topps = [0.0, 1.0, 2.0, 0.5], [0.9, 0.9, 0.5, 1.0]
    monkeypatch.setattr(TS, "philox_words",
                        lambda seed, b, v, r, k, device: torch.zeros(b, v, k, dtype=torch.int64))
    with pltpu.force_tpu_interpret_mode():
        jt, jr, jl, _, _ = JDS.fused_decode_step(
            jpacked, jnp.asarray(x0), cache["k"], cache["v"], jnp.int32(idx), n_head=CFG.n_head,
            vocab=CFG.vocab_size, sample={"temp": jnp.asarray(temps, jnp.float32),
                                          "top_p": jnp.asarray(topps, jnp.float32), "seed": 1})
    tt, tr, tl, _, _ = TDS.fused_decode_step(
        tpacked, torch.from_numpy(x0), _t(cache["k"]), _t(cache["v"]), idx, n_head=CFG.n_head,
        sample={"temp": torch.tensor(temps), "top_p": torch.tensor(topps), "seed": 1})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["greedy", "emit_logits"])
@pytest.mark.parametrize("weights", ["int8", "float"])
def test_int8_cache_step_matches_jax_kernel(mode, weights):
    """The int8 KV cache (with W8A8 weights and without): logits to 1e-4 of
    the largest |logit| (greedy: tokens equal), the appended int8 row equal to
    the JAX kernel's and its scales to 1e-6 (as the float caches' rows: the
    new K/V rows come from float32 products summed in another order), every
    other row untouched, and the step returns the updated scales."""
    params = JG.init(jax.random.PRNGKey(0), CFG)
    quant = weights == "int8"
    jpacked = JDS.pack_decode_weights(params, compute_dtype=jnp.float32, quant=quant)
    tpacked = TDS.pack_decode_weights(jax.tree.map(_t, params), torch.float32, quant=quant)
    b = 5
    cache, x0 = _prefilled(params, b, p_len=6, seed=2)
    idx = int(cache["index"])
    jkq, jvq, jks, jvs = JDS.quantize_cache(cache["k"], cache["v"])
    kq, vq, ks, vs = (_t(a) for a in (jkq, jvq, jks, jvs))
    before = [a.clone() for a in (kq, vq, ks, vs)]
    emit = mode == "emit_logits"
    want = _jax_step(jpacked, x0, jkq, jvq, idx, k_scale=jks, v_scale=jvs, emit_logits=emit)
    got = TDS.fused_decode_step(tpacked, torch.from_numpy(x0), kq, vq, idx, n_head=CFG.n_head,
                                k_scale=ks, v_scale=vs, emit_logits=emit)
    assert len(got) == 5 and got[1] is kq and got[3] is ks
    if emit:
        _assert_logits_close(got[0].numpy(), want[0])
    else:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for new, old, jax_new in zip((kq, vq, ks, vs), before, want[1:]):
        np.testing.assert_array_equal(new[:, :idx].numpy(), old[:, :idx].numpy())
        np.testing.assert_array_equal(new[:, idx + 1 :].numpy(), old[:, idx + 1 :].numpy())
        if new.dtype == torch.int8:
            np.testing.assert_array_equal(new[:, idx].numpy(), np.asarray(jax_new)[:, idx])
        else:  # a max of k_new, which the two sides' products give to ~1e-7
            np.testing.assert_allclose(new[:, idx].numpy(), np.asarray(jax_new)[:, idx],
                                       atol=0, rtol=1e-6)


def test_int8_cache_start_window_matches_jax_kernel():
    """int8 cache with continuous batching's start windows (no JAX caller
    combines them, but the JAX kernel takes both): logits equal to 1e-4."""
    params, jpacked, _, tpacked = _packs(seed=1)
    b = 4
    cache, x0 = _prefilled(params, b, p_len=7, seed=8)
    idx = int(cache["index"])
    start = np.array([0, 2, 5, idx], np.int32)
    jkq, jvq, jks, jvs = JDS.quantize_cache(cache["k"], cache["v"])
    want = _jax_step(jpacked, x0, jkq, jvq, idx, k_scale=jks, v_scale=jvs, emit_logits=True,
                     start=jnp.asarray(start))
    got = TDS.fused_decode_step(tpacked, torch.from_numpy(x0), _t(jkq), _t(jvq), idx,
                                n_head=CFG.n_head, k_scale=_t(jks), v_scale=_t(jvs),
                                emit_logits=True, start=_t(start))
    _assert_logits_close(got[0].numpy(), want[0])


def test_int8_cache_attention_twin_reads_dequantized_rows_and_the_exact_new_row():
    """The attention twin on an int8 cache equals float attention over the
    rows dequantized in the compute dtype, with the new row's own term from
    the unquantized k_new / v_new; through an ancestry map, each position's
    scale follows its source row."""
    rng = np.random.default_rng(5)
    t, b, d, h, idx = 16, 4, 32, 2, 9
    q, kn, vn = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)) for _ in range(3))
    kf, vf = (torch.from_numpy(rng.normal(size=(t, b, d)).astype(np.float32)) for _ in range(2))
    kq, vq, ks, vs = TQ.quantize_cache(kf[None], vf[None])
    kq, vq, ks, vs = kq[0], vq[0], ks[0], vs[0]
    origin = torch.from_numpy(rng.integers(0, b, size=(t, b)).astype(np.int32))
    for mode in ({}, {"origin": origin, "gather_start": 3}):
        kc, vc, ksc, vsc = kq.clone(), vq.clone(), ks.clone(), vs.clone()
        got, _, _ = TDA.decode_attention(q, kn, vn, kc, vc, idx, n_head=h, k_scale=ksc,
                                         v_scale=vsc, **mode)
        kd, vd = TQ.dequant(kq, ks, torch.float32), TQ.dequant(vq, vs, torch.float32)
        want = TDA._decode_attention_plain(q, kn, vn, kd, vd, idx, h, **mode)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        qn, sn = TQ.absmax_quant(kn)
        assert torch.equal(kc[idx], qn) and torch.equal(ksc[idx], sn[:, 0])
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        TDA.decode_attention(q, kn, vn, kq.clone(), vq.clone(), idx, n_head=h)


@pytest.mark.parametrize("part", ["layer_norm", "attention", "gelu"])
def test_step_twins_round_the_exact_result_in_any_order(part):
    """The step's order-sensitive parts — the LayerNorm statistics, the
    attention's sums and softmax, gelu_new — are computed in float64 and
    rounded once, so reordering their inputs gives the same bits (the
    kernels compute them so too, and an int8 step on the card then equals
    its twin's step); each stays within a float32 rounding of its float32
    form."""
    rng = np.random.default_rng(11)
    if part == "layer_norm":
        x = torch.from_numpy((rng.normal(size=(64, 768)) * 40 + 300).astype(np.float32))
        scale, bias = (torch.from_numpy(rng.normal(size=768).astype(np.float32)) for _ in range(2))
        perm = torch.from_numpy(rng.permutation(768))
        got = TDS.nn.layer_norm_rows(scale, bias, x, 1e-5)
        again = TDS.nn.layer_norm_rows(scale[perm], bias[perm], x[:, perm], 1e-5)
        assert torch.equal(again, got[:, perm]) and got.dtype == torch.float32
        want = TDS.nn.layer_norm({"scale": scale, "bias": bias}, x, 1e-5)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    elif part == "attention":
        t, b, d, h, idx = 48, 3, 64, 2, 40
        q, kn, vn = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32) * 3)
                     for _ in range(3))
        kc, vc = (torch.from_numpy(rng.normal(size=(t, b, d)).astype(np.float32) * 3)
                  for _ in range(2))
        perm = torch.cat([torch.from_numpy(rng.permutation(idx)), torch.arange(idx, t)])
        got = TDA._decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), idx, h)
        again = TDA._decode_attention_plain(q, kn, vn, kc[perm].clone(), vc[perm].clone(), idx, h)
        assert torch.equal(again, got)
        qh, kh, vh = q.reshape(b, h, -1), kc[: idx + 1].clone(), vc[: idx + 1].clone()
        kh[idx], vh[idx] = kn, vn
        s = torch.einsum("bhd,kbhd->bhk", qh, kh.reshape(idx + 1, b, h, -1)) / np.sqrt(d // h)
        want = torch.einsum("bhk,kbhd->bhd", torch.softmax(s, dim=-1),
                            vh.reshape(idx + 1, b, h, -1)).reshape(b, d)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        y = torch.from_numpy((rng.normal(size=(4096,)) * 3).astype(np.float32))
        got = TDS._gelu_new(y)
        x = y.double()
        exact = (0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3))))
        assert torch.equal(got, exact.float()) and got.dtype == torch.float32
        torch.testing.assert_close(got, TDS.nn.gelu_new(y), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["topk", "sample"])
def test_int8_cache_refuses_topk_and_sample(mode):
    """As the JAX kernel (decode_step.py:1075, :1078): top-k and the in-kernel
    draw have no int8-cache variant; scales without an int8 cache raise too."""
    params, _, _, tpacked = _packs()
    cache, x0 = _prefilled(params, 4, p_len=3)
    kq, vq, ks, vs = TDS.quantize_cache(_t(cache["k"]), _t(cache["v"]))
    call = functools.partial(TDS.fused_decode_step, tpacked, torch.from_numpy(x0), kq, vq,
                             int(cache["index"]), n_head=CFG.n_head, k_scale=ks, v_scale=vs)
    kw = ({"topk": 2} if mode == "topk"
          else {"sample": {"temp": torch.ones(4), "top_p": torch.ones(4), "seed": 0}})
    with pytest.raises(ValueError, match="no int8-cache variant"):
        call(**kw)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        TDS.fused_decode_step(tpacked, torch.from_numpy(x0), _t(cache["k"]), _t(cache["v"]),
                              int(cache["index"]), n_head=CFG.n_head, k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# the entry points against the JAX package's
# ---------------------------------------------------------------------------

MAX_LEN = 8


def _models(eos=208, wpe_scale=8.0):
    gkw = dict(vocab_size=293, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=16, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=eos)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=eos)
    tr, fz = JC.init_params(jax.random.PRNGKey(3), jcfg)
    fz = dict(fz, gpt=dict(fz["gpt"], wpe=fz["gpt"]["wpe"] * wpe_scale))
    emb = np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return jcfg, tcfg, tr, fz, ttr, tfz, emb


@pytest.mark.parametrize("quant_cache", [False, True], ids=["w8a8", "w8a8_int8_kv"])
def test_generate_int8_tokens_match_jax(quant_cache):
    """Greedy ``generate(decode_quant=True[, decode_quant_cache=True])``: the
    JAX function's tokens through its step kernel in interpret mode; the
    int8 path is not the float one (the tokens differ somewhere)."""
    jcfg, tcfg, tr, fz, ttr, tfz, emb = _models()
    kw = dict(max_length=MAX_LEN, temperature=0.0, decode_quant=True,
              decode_quant_cache=quant_cache)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JC.generate(tr, fz, jcfg, jnp.asarray(emb), use_pallas_decode=True,
                                      **kw))
    got = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    packed = TC.prepare_decode_weights(ttr, tfz, tcfg, quant=True)
    again = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), packed=packed, **kw)
    assert torch.equal(again, got)
    with pytest.raises(ValueError, match="decode_quant=False needs a pack with quant=False"):
        TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), packed=packed, max_length=MAX_LEN,
                    temperature=0.0)


@pytest.mark.parametrize("beam_size", [2, 4])
def test_beam_generate_int8_tokens_match_jax(beam_size):
    """``beam_generate(decode_quant=True)`` against the JAX beam-aware int8
    step kernel in interpret mode, token for token."""
    jcfg, tcfg, tr, fz, ttr, tfz, emb = _models()
    kw = dict(max_length=MAX_LEN, beam_size=beam_size, decode_quant=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JC.beam_generate(tr, fz, jcfg, jnp.asarray(emb),
                                           use_pallas_decode=True, **kw))
    got = TC.beam_generate(ttr, tfz, tcfg, torch.from_numpy(emb), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_cache_sampling_paths():
    """Sampled decoding with the int8 cache draws from the emitted logits;
    asked for the in-kernel draw, it warns and does the same (the JAX
    package's fallback: the draw has no int8-cache variant).  Both decode
    W8A8 with the int8 cache all the way."""
    _, tcfg, _, _, ttr, tfz, emb = _models()
    x = torch.from_numpy(emb)
    kw = dict(max_length=MAX_LEN, temperature=1.0, decode_quant=True, decode_quant_cache=True)
    tail = TC.generate(ttr, tfz, tcfg, x, generator=torch.Generator().manual_seed(2), **kw)
    with pytest.warns(UserWarning, match="no int8-KV-cache variant"):
        warned = TC.generate(ttr, tfz, tcfg, x, generator=torch.Generator().manual_seed(2),
                             sample_in_kernel=True, **kw)
    assert torch.equal(tail, warned)
    in_kernel = TC.generate(ttr, tfz, tcfg, x, max_length=MAX_LEN, temperature=1.0,
                            decode_quant=True, sample_in_kernel=True)
    assert in_kernel.shape == (4, MAX_LEN)


def test_model_facade_int8_decodes_the_bf16_copy_and_caches_both_packs():
    """``decode_precision="int8"`` packs the cached bf16 copy W8A8 (its tokens
    are module-level ``generate``'s on that copy with ``decode_quant``), the
    bf16 and int8 packs stay cached side by side, and ``decode_params``
    still refuses "int8", as the JAX façade does."""
    _, tcfg, _, _, ttr, tfz, emb = _models()
    model = TC.ImageCaptioningModel(tcfg, device="cpu")
    model.trainable, model.frozen = ttr, tfz
    got = model.generate(emb, max_length=MAX_LEN, temperature=0.0, decode_precision="int8")
    tr, fz, pol = model.decode_params("bf16")
    want = TC.generate(tr, fz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                       temperature=0.0, policy=pol, decode_quant=True)
    assert torch.equal(got, want)
    bf16 = model.generate(emb, max_length=MAX_LEN, temperature=0.0, decode_precision="bf16")
    assert bf16.shape == got.shape
    packs = model._packed_cache[3]
    assert set(packs) == {False, True} and "qkvs" in packs[True] and "qkvs" not in packs[False]
    assert packs[True]["wte"].dtype == torch.int8 and packs[False]["wte"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="decode_precision"):
        model.decode_params("int8")


def test_int8_service_matches_one_shot_int8_generate():
    """The int8 ``ContinuousCaptionService`` gives one-shot int8 ``generate``'s
    captions (as tests/test_continuous.py requires of the JAX service),
    across staggered admission, compaction and per-request caps."""
    from helpers import tiny_tokenizer
    from gpt2_image_captioning_tpu_torch.data import tokenizer as TT

    jtok = tiny_tokenizer()
    n = len(jtok.encoder)
    merges = sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get)
    tok = TT.GPT2BPETokenizer(dict(jtok.encoder), merges)
    gkw = dict(vocab_size=n, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw),
                              mapping=TM.MLPMappingConfig(prefix_length=2, embed_dim=8, gpt_dim=32),
                              eos_token_id=n - 1)
    model = TC.ImageCaptioningModel(tcfg, tokenizer=tok, generator=torch.Generator().manual_seed(5),
                                    device="cpu")
    embs = np.random.default_rng(33).normal(size=(7, 8)).astype(np.float32)
    caps = [6, 3, 1, 6, 2, 6, 5]
    ids = model.generate(embs, max_length=6, temperature=0.0, decode_precision="int8").numpy()
    want = [tok.batch_decode(ids[i : i + 1, : caps[i]], skip_special_tokens=True)[0]
            for i in range(len(embs))]
    svc = ContinuousCaptionService(model, slots=3, segment=2, bursts=2, admit=2, max_length=6,
                                   decode_precision="int8")
    assert "qkvs" in svc._packed and svc._pol.compute_dtype == torch.bfloat16
    rids = [svc.submit_embedding(e, max_length=c) for e, c in zip(embs, caps)]
    svc.drain()
    assert [svc.pop_result(r) for r in rids] == want
