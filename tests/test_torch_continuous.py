"""The port's continuous batching against the JAX package's, in float32 at a
tiny config: the step's per-row ``start`` window, the host-driven
``decode_segment`` / ``admit_prefill``, the on-device ``macro_step`` and
``ContinuousCaptionService`` (the JAX side runs its Pallas step in interpret
mode), the port's tokenizer copy, and the sampled engine's noise keyed off
the step counter."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.data import tokenizer as JT
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import continuous as JCE
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.ops import decode_step as JDS
from gpt2_image_captioning_tpu.serving import ContinuousCaptionService as JService
from gpt2_image_captioning_tpu_torch.core.mesh import Mesh, create_mesh
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.data import tokenizer as TT
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import continuous as TCE
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.ops import decode_attention as TDA
from gpt2_image_captioning_tpu_torch.ops import decode_step as TDS
from gpt2_image_captioning_tpu_torch.serving import ContinuousCaptionService

from helpers import tiny_tokenizer

GCFG = dict(vocab_size=293, n_positions=128, n_embd=32, n_layer=2, n_head=2)

# a mesh with a tensor-parallel axis, which the port refuses
TP2 = Mesh(dp=1, tp=2, rank=0, world_size=1, group=None, backend=None,
           device=torch.device("cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the step's per-row start window
# ---------------------------------------------------------------------------

_jax_step = jax.jit(functools.partial(JDS.fused_decode_step, n_head=GCFG["n_head"],
                                      vocab=GCFG["vocab_size"], interpret=True),
                    static_argnames=("emit_logits", "block_b"))


@pytest.mark.parametrize("emit_logits", [False, True], ids=["greedy", "emit_logits"])
@pytest.mark.parametrize("case", ["windows", "blocks_and_dead_rows"])
def test_fused_step_start_matches_jax(case, emit_logits):
    """Rows of different ages (start offsets, some not chunk-aligned, some
    past chunk 0 of the port's 16-row walk, some dead with start == idx): the
    port's step equals the JAX kernel's, tokens (or logits) and caches."""
    cfg = JG.GPT2Config(**GCFG)
    params = JG.init(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(9)
    if case == "windows":
        b, tpad, idx, block_b = 3, 32, 15, None
        start = [8, 10, 12]
    else:  # the JAX per-block chunk skip at block_b 8 (test_continuous.py:973), dead rows
        b, tpad, idx, block_b = 16, 64, 40, 8
        start = [2 + i for i in range(8)] + [32 + i for i in range(6)] + [40, 40]
    k = rng.normal(size=(cfg.n_layer, tpad, b, cfg.n_embd)).astype(np.float32)
    v = rng.normal(size=(cfg.n_layer, tpad, b, cfg.n_embd)).astype(np.float32)
    x0 = rng.normal(size=(b, cfg.n_embd)).astype(np.float32)
    start = np.asarray(start, np.int32)
    want, kw, vw = _jax_step(
        JDS.pack_decode_weights(params, compute_dtype=jnp.float32), jnp.asarray(x0),
        jnp.asarray(k), jnp.asarray(v), jnp.int32(idx), start=jnp.asarray(start),
        emit_logits=emit_logits, block_b=block_b,
    )
    tparams = jax.tree.map(_t, params)
    kt, vt = _t(k), _t(v)
    got, _, _ = TDS.fused_decode_step(
        TDS.pack_decode_weights(tparams, torch.float32), _t(x0), kt, vt, idx,
        n_head=cfg.n_head, start=_t(start), emit_logits=emit_logits,
    )
    if emit_logits:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kw), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vw), atol=1e-6, rtol=1e-6)


def test_start_window_masks_history_and_refuses_origin():
    """Rows below start_r never count (garbage there changes nothing), a dead
    row attends its new row alone, and start with an ancestry map raises."""
    rng = np.random.default_rng(4)
    b, tk, d, idx = 4, 48, 32, 33
    q, kn, vn = (_t(rng.normal(size=(b, d)).astype(np.float32)) for _ in range(3))
    kc = _t(rng.normal(size=(tk, b, d)).astype(np.float32))
    vc = _t(rng.normal(size=(tk, b, d)).astype(np.float32))
    start = torch.tensor([0, 17, 20, idx], dtype=torch.int32)
    want = TDA.decode_attention(q, kn, vn, kc.clone(), vc.clone(), idx, n_head=4,
                                start=start)[0]
    kg, vg = kc.clone(), vc.clone()
    for r, s in enumerate(start.tolist()):
        kg[:s, r], vg[:s, r] = 1e6, -1e6
    got = TDA.decode_attention(q, kn, vn, kg, vg, idx, n_head=4, start=start)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got[3], vn[3])  # the dead row: its own value row
    with pytest.raises(ValueError, match="exclusive"):
        TDA.decode_attention(q, kn, vn, kc, vc, idx, n_head=4, start=start,
                             origin=torch.zeros(tk, b, dtype=torch.int32))


# ---------------------------------------------------------------------------
# shared tiny captioner: the JAX model and the port on the same weights
# ---------------------------------------------------------------------------

def _models(vocab_size=293, eos=292, prefix_length=2, embed_dim=8, seed=5):
    jcfg = JC.CaptionerConfig(
        gpt2=JG.GPT2Config(vocab_size=vocab_size, n_positions=64, n_embd=32, n_layer=2,
                           n_head=2),
        mapping=JM.MLPMappingConfig(prefix_length=prefix_length, embed_dim=embed_dim,
                                    gpt_dim=32),
        eos_token_id=eos)
    tcfg = TC.CaptionerConfig(
        gpt2=TG.GPT2Config(vocab_size=vocab_size, n_positions=64, n_embd=32, n_layer=2,
                           n_head=2),
        mapping=TM.MLPMappingConfig(prefix_length=prefix_length, embed_dim=embed_dim,
                                    gpt_dim=32),
        eos_token_id=eos)
    tr, fz = JC.init_params(jax.random.PRNGKey(seed), jcfg)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return jcfg, tcfg, tr, fz, ttr, tfz


# ---------------------------------------------------------------------------
# (b) decode_segment + admit_prefill
# ---------------------------------------------------------------------------

def test_segment_and_admission_match_jax():
    """The same staggered admissions and segments through both packages'
    host-driven primitives: first tokens, segment tokens, finished masks and
    caches agree at every call."""
    jcfg, tcfg, tr, fz, ttr, tfz = _models(prefix_length=4, embed_dim=16, seed=5)
    p, s_slots, t_max, seg = 4, 4, 64, 4
    embs = np.random.default_rng(11).normal(size=(6, 16)).astype(np.float32)
    gp, tgp = JC._gpt(tr, fz), TC._gpt(ttr, tfz)
    shape = (2, t_max, s_slots, 32)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    idx = p
    start = np.full(s_slots, p, np.int32)
    prev = np.zeros(s_slots, np.int32)
    finished = np.ones(s_slots, bool)
    with pltpu.force_tpu_interpret_mode():
        jpacked = JC.prepare_decode_weights(tr, fz, jcfg, policy=JF32)
        tpacked = TC.prepare_decode_weights(ttr, tfz, tcfg, F32)
        plan = [([0, 1], [0, 1]), None, ([2, 3], [2, 3, 2]), None, ([1], [4])]
        for admit in plan:
            if admit is not None:
                rows, reqs = admit
                n = len(reqs)
                rows_a = np.asarray((rows * n)[:n], np.int32)
                valid = np.asarray([i < len(rows) for i in range(n)])
                rows_a[~valid] = rows_a[0]
                # the port's padding names other rows (live ones here),
                # which keep their values; the JAX padding repeats rows[0]
                trows = rows_a.copy()
                trows[~valid] = [r for r in range(s_slots) if r not in rows][: int((~valid).sum())]
                emb_a = embs[np.asarray(reqs)]
                jf, jk, jv = JC.admit_prefill(tr, fz, jcfg, jnp.asarray(emb_a), jk, jv,
                                              jnp.int32(idx), jnp.asarray(rows_a),
                                              jnp.asarray(valid), policy=JF32)
                tl, tk, tv = TC.admit_prefill(ttr, tfz, tcfg, _t(emb_a), tk, tv, idx,
                                              _t(trows), _t(valid), policy=F32,
                                              packed=tpacked)
                tf = torch.argmax(tl, dim=-1).to(torch.int32)
                np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
                for i, r in enumerate(rows):
                    start[r], prev[r], finished[r] = idx - p, int(tf[i]), False
            jt, jk, jv, _, jprev, jfin = JC.decode_segment(
                jpacked, gp["wte"], gp["wpe"], jk, jv, jnp.int32(idx), jnp.asarray(start),
                jnp.asarray(prev), jnp.asarray(finished), cfg=jcfg, steps=seg, policy=JF32)
            tt, tk, tv, idx, tprev, tfin = TC.decode_segment(
                tpacked, tgp["wte"], tgp["wpe"], tk, tv, idx, _t(start), _t(prev),
                _t(finished), cfg=tcfg, steps=seg, policy=F32)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
            prev, finished = tprev.numpy().copy(), tfin.numpy().copy()


# ---------------------------------------------------------------------------
# (c) macro_step
# ---------------------------------------------------------------------------

def test_macro_step_output_matches_jax_across_compaction():
    """Greedy macros with staggered admission, per-request caps and the
    minimal t_max (every later macro compacts), until the pool drains: the
    port's packed output matrix equals the JAX engine's exactly, macro by
    macro, and so do the pool's row state and the append position."""
    jcfg, tcfg, tr, fz, ttr, tfz = _models()
    p, slots, seg, bursts, admit, max_len = 2, 3, 2, 2, 2, 6
    t_max = 16  # p + max_len + bursts * seg, rounded to 8
    rng = np.random.default_rng(3)
    n_req = 9
    embs = rng.normal(size=(n_req, 8)).astype(np.float32)
    caps = np.asarray([6, 3, 1, 6, 5, 6, 2, 6, 4], np.int32)
    q_cap = 4
    jstate = JCE.init_state(jcfg, slots, t_max, p, JF32)
    tstate = TCE.init_state(tcfg, slots, t_max, p, F32, device="cpu")
    tpacked = TC.prepare_decode_weights(ttr, tfz, tcfg, F32)
    head = macros = 0
    with pltpu.force_tpu_interpret_mode():
        jpacked = JC.prepare_decode_weights(tr, fz, jcfg, policy=JF32)
        while head < n_req or not bool(tstate["finished"].all()):
            macros += 1
            assert macros <= 12, "the pool did not drain"
            block = np.arange(head, min(head + q_cap, n_req))
            emb_q = np.zeros((q_cap, 8), np.float32)
            cap_q = np.full(q_cap, max_len, np.int32)
            uid_q = np.full(q_cap, -1, np.int32)
            emb_q[: len(block)], cap_q[: len(block)], uid_q[: len(block)] = (
                embs[block], caps[block], block)
            jstate, jout = JCE.macro_step(
                jpacked, tr, fz, jstate, jnp.asarray(emb_q), jnp.asarray(cap_q),
                jnp.asarray(uid_q), jnp.int32(len(block)), cfg=jcfg, policy=JF32, seg=seg,
                bursts=bursts, admit=admit)
            tstate, tout = TCE.macro_step(
                tpacked, ttr, tfz, tstate, _t(emb_q), _t(cap_q), _t(uid_q), len(block),
                cfg=tcfg, policy=F32, seg=seg, bursts=bursts, admit=admit)
            jout = np.asarray(jout)
            assert tout.shape == (bursts * seg, 4, slots) and tout.dtype == torch.int32
            np.testing.assert_array_equal(tout.numpy(), jout)
            for key in ("start", "prev", "finished", "gen", "cap", "uid"):
                np.testing.assert_array_equal(tstate[key].numpy(), np.asarray(jstate[key]), key)
            assert tstate["idx"] == int(jstate["idx"]) and tstate["t"] == int(jstate["t"])
            head += int((jout[:, 3] >= 0).sum())
    assert tstate["host_reads"] == macros >= 4


def test_admission_rows_prefer_the_emptiest_block():
    """admit_affinity's row choice (the JAX engine's key): at 384 slots (three
    128-row blocks) the free rows of the block with the most free rows come
    first, lowest row first within it; without affinity, lowest free first."""
    free = torch.zeros(384, dtype=torch.bool)
    free[[5, 6, 130, 131, 132, 300]] = True
    torch.testing.assert_close(TCE.admission_rows(free, 4), torch.tensor([5, 6, 130, 131]))
    torch.testing.assert_close(TCE.admission_rows(free, 4, affinity=True),
                               torch.tensor([130, 131, 132, 5]))
    assert TCE.affinity_block(512) == 256 and TCE.affinity_block(384) == 128


# ---------------------------------------------------------------------------
# (d) ContinuousCaptionService
# ---------------------------------------------------------------------------

def _port_tokenizer():
    jtok = tiny_tokenizer()
    merges = sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get)
    return TT.GPT2BPETokenizer({k: v for k, v in jtok.encoder.items()}, merges)


def _service_models():
    tok = tiny_tokenizer()
    n = len(tok.encoder)
    jcfg, tcfg, tr, fz, ttr, tfz = _models(vocab_size=n, eos=n - 1, seed=5)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=tok)
    jmodel.trainable, jmodel.frozen = tr, fz
    tmodel = TC.ImageCaptioningModel(tcfg, tokenizer=_port_tokenizer(), device="cpu")
    tmodel.trainable, tmodel.frozen = ttr, tfz
    return jmodel, tmodel


def test_service_matches_jax_service_and_one_shot_generate():
    """Both services fed the same embeddings give the same captions, which are
    the port's one-shot greedy captions, across staggered admission,
    compaction (minimal t_max), per-request caps and pool reuse after a
    drain; the sizing helpers and telemetry agree with the JAX service's."""
    jmodel, tmodel = _service_models()
    embs = np.random.default_rng(7).normal(size=(10, 8)).astype(np.float32)
    kw = dict(slots=3, segment=2, bursts=2, admit=2, max_length=6)
    svc = ContinuousCaptionService(tmodel, **kw)
    assert svc.t_max == 16
    want = tmodel.generate_captions(embs, max_length=6, temperature=0.0)
    caps = [6, 3, 1, 6, 2, 6, 6, 5, 6, 4]
    with pltpu.force_tpu_interpret_mode():
        jsvc = JService(jmodel, None, None, **kw)
        assert jsvc.t_max == svc.t_max and jsvc.q_cap == svc.q_cap
        assert jsvc.recommended_inflight() == svc.recommended_inflight()
        assert jsvc.recommended_inflight(49) == svc.recommended_inflight(49)
        jr = [jsvc.submit_embedding(e, max_length=c) for e, c in zip(embs, caps)]
        jsvc.drain()
        jgot = [jsvc.pop_result(r) for r in jr]
    tr_ = [svc.submit_embedding(e, max_length=c) for e, c in zip(embs, caps)]
    svc.drain()
    got = [svc.pop_result(r) for r in tr_]
    assert got == jgot
    ids = tmodel.generate(embs, max_length=6, temperature=0.0).numpy()
    tok = tmodel.tokenizer
    assert got == [tok.batch_decode(ids[i : i + 1, : caps[i]], skip_special_tokens=True)[0]
                   for i in range(10)]
    stats = svc.stats
    assert stats["images"] == 10 and stats["macros"] > 2 and 0.0 < stats["occupancy"] <= 1.0
    assert stats["host_reads"] == stats["macros"]  # one compaction shift per macro
    assert stats["latency_p50_s"] <= stats["latency_p95_s"]
    # the pool is drained and reusable
    assert svc.step() == {}
    rids = [svc.submit_embedding(e) for e in embs[:3]]
    svc.drain()
    assert [svc.pop_result(r) for r in rids] == want[:3]


@pytest.mark.parametrize("depth", [1, 2])
def test_service_affinity_and_pipeline_depth_keep_captions(depth):
    """admit_affinity only reorders which free rows admit, and a deeper
    dispatch pipeline only makes admission staler: the captions stay the
    one-shot greedy ones (384 slots: three 128-row affinity blocks)."""
    _, tmodel = _service_models()
    embs = np.random.default_rng(8).normal(size=(400, 8)).astype(np.float32)
    want = tmodel.generate_captions(embs, max_length=6, temperature=0.0)
    svc = ContinuousCaptionService(tmodel, slots=384, segment=2, bursts=2, admit=64,
                                   max_length=6, admit_affinity=True, pipeline_depth=depth)
    rids = [svc.submit_embedding(e, max_length=6 - i % 3) for i, e in enumerate(embs)]
    svc.drain()
    got = [svc.pop_result(r) for r in rids]
    ids = tmodel.generate(embs, max_length=6, temperature=0.0).numpy()
    assert got == [tmodel.tokenizer.batch_decode(ids[i : i + 1, : 6 - i % 3],
                                                 skip_special_tokens=True)[0]
                   for i in range(len(embs))]


def test_service_sampling_modes_and_refusals():
    """Per-request sampling mixes greedy rows (exactly one-shot greedy) with
    sampled ones, deterministic per seed in both sampling modes; int8
    serving gives one-shot int8 captions; what is not ported raises, naming
    its slice; bad requests raise."""
    _, tmodel = _service_models()
    embs = np.random.default_rng(41).normal(size=(6, 8)).astype(np.float32)
    want = tmodel.generate_captions(embs, max_length=6, temperature=0.0)

    def run(seed, **kw):
        svc = ContinuousCaptionService(tmodel, slots=3, segment=2, bursts=2, admit=2,
                                       max_length=6, seed=seed, per_request_sampling=True, **kw)
        rids = [svc.submit_embedding(e) if i % 2 == 0
                else svc.submit_embedding(e, temperature=1.0, top_p=0.9)
                for i, e in enumerate(embs)]
        svc.drain()
        return [svc.pop_result(r) for r in rids]

    for kw in ({}, {"sample_in_kernel": True}):
        a1, a2, b = run(3, **kw), run(3, **kw), run(4, **kw)
        assert a1 == a2 and a1[0::2] == want[0::2] and b[0::2] == want[0::2]
        assert b[1::2] != a1[1::2]
    svc = ContinuousCaptionService(tmodel, slots=3, max_length=6)
    with pytest.raises(ValueError, match="per_request_sampling"):
        svc.submit_embedding(embs[0], temperature=1.0)
    with pytest.raises(ValueError, match="top_p"):
        svc.submit_embedding(embs[0], top_p=1.5)
    # image intake needs a vision tower, and this service was built without one
    for fn, arg in ((svc.submit_array, np.zeros((8, 8, 3), np.uint8)),
                    (svc.submit_prepped, np.zeros((224, 224, 3), np.uint8)),
                    (svc.caption_arrays, [np.zeros((8, 8, 3), np.uint8)])):
        with pytest.raises(ValueError, match="no vision tower"):
            fn(arg)
    with pytest.raises(NotImplementedError, match="queue 1: tensor parallelism"):
        ContinuousCaptionService(tmodel, mesh=TP2)
    # a one-rank mesh serves as no mesh does
    one = ContinuousCaptionService(tmodel, slots=3, max_length=6, mesh=create_mesh(device="cpu"))
    rids = [one.submit_embedding(e) for e in embs[:4]]
    one.drain()
    assert [one.pop_result(r) for r in rids] == tmodel.generate_captions(
        embs[:4], max_length=6, temperature=0.0)
    svc8 = ContinuousCaptionService(tmodel, slots=3, max_length=6, decode_precision="int8")
    assert "qkvs" in svc8._packed and svc8._pol.compute_dtype == torch.bfloat16
    rid = svc8.submit_embedding(embs[0])
    svc8.drain()
    assert svc8.pop_result(rid) == tmodel.generate_captions(
        embs[:1], max_length=6, temperature=0.0, decode_precision="int8")[0]
    with pytest.raises(ValueError, match="top_p >= 0.5"):
        ContinuousCaptionService(tmodel, temperature=1.0, top_p=0.3, sample_in_kernel=True)
    svc = ContinuousCaptionService(tmodel, temperature=1.0, sample_in_kernel=True)
    with pytest.raises(ValueError, match="top_p >= 0.5"):
        svc.submit_embedding(embs[0], top_p=0.3)
    # the dp engine on a one-rank mesh: init_state's pool, macro_step's output
    tr, fz, pol = tmodel.decode_params(None)
    cfg, p = tmodel.cfg, tmodel.cfg.total_prefix_length
    one = create_mesh(device="cpu")
    a = TCE.init_state(cfg, 3, 16, p, pol, device="cpu")
    b = TCE.init_state_dp(cfg, one, 3, 16, p, pol)
    assert sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)
    packed = TC.prepare_decode_weights(tr, fz, cfg, pol)
    q = [torch.from_numpy(embs[:3]), torch.full((3,), 6, dtype=torch.int32),
         torch.arange(3, dtype=torch.int32)]
    kw = dict(cfg=cfg, policy=pol, seg=2, bursts=2, admit=2)
    a, out_a = TCE.macro_step(packed, tr, fz, a, *q, 3, **kw)
    b, out_b = TCE.macro_step_dp(one, packed, tr, fz, b, *q, [3], **kw)
    assert torch.equal(out_a, out_b) and a["idx"] == b["idx"]
    two = Mesh(dp=2, tp=1, rank=0, world_size=2, group=None, backend=None,
               device=torch.device("cpu"))
    with pytest.raises(ValueError, match="slots 3 must divide over dp=2"):
        TCE.init_state_dp(cfg, two, 3, 16, p, pol)
    with pytest.raises(ValueError, match="slots 3 must divide over dp=2"):
        ContinuousCaptionService(tmodel, slots=3, mesh=two)


# ---------------------------------------------------------------------------
# (h) the sampled engine's noise is keyed off the step counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sample_in_kernel", [False, True], ids=["logits_tail", "in_kernel"])
def test_sampled_captions_do_not_depend_on_compaction(sample_in_kernel, monkeypatch):
    """A sampled service with the minimal t_max compacts at every macro
    entry; one with room to spare and compaction switched off lets the
    append position grow.  Their captions are identical: the noise follows
    the monotone step counter, not the rebased append position."""
    _, tmodel = _service_models()
    embs = np.random.default_rng(13).normal(size=(8, 8)).astype(np.float32)
    out, idx = [], []
    for t_max in (None, 128):
        if t_max:
            monkeypatch.setattr(TCE, "compaction_shift", lambda *args: 0)
        svc = ContinuousCaptionService(tmodel, slots=3, segment=2, bursts=2, admit=2,
                                       max_length=6, t_max=t_max, temperature=1.0, top_p=0.9,
                                       seed=5, sample_in_kernel=sample_in_kernel)
        rids = [svc.submit_embedding(e) for e in embs]
        svc.drain()
        out.append([svc.pop_result(r) for r in rids])
        idx.append(svc._state["idx"])
    assert idx[0] <= 16 < idx[1]  # the runs' append positions parted
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# (i) the tokenizer copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["the cat on the dog", "a cat at the dog<|endoftext|>",
                                  "  Ünïcode… 123 don't!", ""])
def test_tokenizer_copy_matches_jax(text):
    jtok, ttok = tiny_tokenizer(), _port_tokenizer()
    ids = jtok.encode(text)
    assert ttok.encode(text) == ids
    assert ttok.decode(ids) == jtok.decode(ids) == text
    assert ttok.batch_decode([ids], skip_special_tokens=True) == jtok.batch_decode(
        [ids], skip_special_tokens=True)
    kw = dict(max_length=8, padding="max_length", truncation=True)
    for key, arr in jtok(text, **kw).items():
        np.testing.assert_array_equal(ttok(text, **kw)[key], arr)
    assert ttok.eos_token_id == jtok.eos_token_id == ttok.pad_token_id
    assert TT.bytes_to_unicode() == JT.bytes_to_unicode()


def test_load_gpt2_tokenizer_names_where_it_looked(tmp_path, monkeypatch):
    monkeypatch.delenv("GPT2_TOKENIZER_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "nowhere" / "vocab.json")):
        TT.load_gpt2_tokenizer(str(tmp_path / "nowhere"))
    jtok = tiny_tokenizer()
    d = tmp_path / "gpt2"
    d.mkdir()
    (d / "vocab.json").write_text(__import__("json").dumps(jtok.encoder))
    merges = sorted(jtok.bpe_ranks, key=jtok.bpe_ranks.get)
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    tok = TT.load_gpt2_tokenizer(str(d))
    assert tok.encode("the cat") == jtok.encode("the cat")
