"""The port's ``generate`` against the JAX package's in float32 at a tiny
config: greedy token for token through both JAX decode paths (the layerwise
XLA loop and the whole-step Pallas kernel in interpret mode); sampled
decoding by its nucleus, since torch's generator draws other numbers than
jax.random."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.ops import sampling as JS
from gpt2_image_captioning_tpu_torch.core.mesh import Mesh, create_mesh
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

MAX_LEN = 12
# (scale of the position embeddings, EOS id).  Unscaled, each random tiny
# model repeats one token per row, so EOS := row 0's token stops that row at
# once and pads it while the others run to MAX_LEN.  With positions scaled up
# the rows share a sequence after step 1: EOS 68 stops three rows at step 1;
# EOS 7 stops every row at step 4, so the loop exits early.
CASES = {"one_row_stops": (1.0, 97), "three_rows_stop": (60.0, 68), "early_exit": (60.0, 7)}


# a mesh with a tensor-parallel axis, which the port refuses
TP2 = Mesh(dp=1, tp=2, rank=0, world_size=1, group=None, backend=None,
           device=torch.device("cpu"))


def _models(case):
    wpe_scale, eos = CASES[case]
    jcfg = JC.CaptionerConfig(
        gpt2=JG.GPT2Config.tiny(),
        mapping=JM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32),
        eos_token_id=eos,
    )
    tcfg = TC.CaptionerConfig(
        gpt2=TG.GPT2Config.tiny(),
        mapping=TM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32),
        eos_token_id=eos,
    )
    tr, fz = JC.init_params(jax.random.PRNGKey(0), jcfg)
    fz = dict(fz, gpt=dict(fz["gpt"], wpe=fz["gpt"]["wpe"] * wpe_scale))
    emb = np.random.default_rng(0).normal(size=(5, 16)).astype(np.float32)
    return jcfg, tcfg, tr, fz, emb


def _min_top2_gap(tr, fz, cfg, emb, tokens):
    """Smallest top-2 logit gap of the JAX model over every (row, step) that
    chose a token, teacher-forced along ``tokens``."""
    gp, gcfg = fz["gpt"], cfg.gpt2
    prefix = JC.build_prefix(tr, cfg, jnp.asarray(emb))
    cache = JG.init_cache(gcfg, prefix.shape[0], prefix.shape[1] + tokens.shape[1])
    logits, cache = JG.forward_cached(gp, gcfg, prefix, cache, fresh_prefill=True)
    alive = np.ones(tokens.shape[0], bool)
    gaps = []
    for s in range(tokens.shape[1]):
        if s > 0:
            emb_t = JG.embed_tokens(gp, jnp.asarray(tokens[:, s - 1 : s]))
            logits, cache = JG.forward_cached(gp, gcfg, emb_t, cache, use_pallas_decode=False)
        top = np.sort(np.asarray(logits), axis=-1)
        gaps.append((top[:, -1] - top[:, -2])[alive].min())
        alive &= tokens[:, s] != cfg.eos_token_id
        if not alive.any():
            break
    return min(gaps)


@pytest.mark.parametrize("jax_path", ["xla", "fused_interpret"])
@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(case, jax_path):
    jcfg, tcfg, tr, fz, emb = _models(case)
    kw = dict(max_length=MAX_LEN, temperature=0.0)
    if jax_path == "xla":
        want = JC.generate(tr, fz, jcfg, jnp.asarray(emb), use_pallas_decode=False, **kw)
    else:
        with pltpu.force_tpu_interpret_mode():
            want = JC.generate(tr, fz, jcfg, jnp.asarray(emb), use_pallas_decode=True, **kw)
    want = np.asarray(want)
    # a near-tie could flip a token by rounding alone, so the case must have none
    assert _min_top2_gap(tr, fz, jcfg, emb, want) > 1e-4

    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    got = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    eos = jcfg.eos_token_id
    stopped = [(row == eos).any() and np.argmax(row == eos) < MAX_LEN - 1 for row in want]
    assert any(stopped)  # EOS came early and the row is padded
    if case == "early_exit":
        assert all(stopped) and (want[:, -1] == eos).all()


def test_build_prefix_with_task_prompt_matches_jax():
    """The task prompt's embeddings (trainable, from wte) follow the mapper's
    prefix tokens."""
    jcfg, tcfg, tr, fz, emb = _models("one_row_stops")
    jcfg = dataclasses.replace(jcfg, task_prompt_ids=(5, 17, 200))
    tcfg = dataclasses.replace(tcfg, task_prompt_ids=(5, 17, 200))
    tr, fz = JC.init_params(jax.random.PRNGKey(4), jcfg)
    assert tcfg.total_prefix_length == 6
    want = JC.build_prefix(tr, jcfg, jnp.asarray(emb))
    ttr, _ = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    got = TC.build_prefix(ttr, tcfg, torch.from_numpy(emb))
    assert tuple(got.shape) == (5, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # the port's own init takes the task prefix from its wte
    ttr2, tfz2 = TC.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    torch.testing.assert_close(ttr2["task_prefix"], tfz2["gpt"]["wte"][[5, 17, 200]])


def test_model_facade_bf16_and_refusals():
    """ImageCaptioningModel: bf16 decode params are cached, generate_captions
    decodes through the tokenizer, int8 decodes the bf16 copy W8A8, and what
    is not ported raises."""
    cfg = TC.CaptionerConfig(
        gpt2=TG.GPT2Config.tiny(),
        mapping=TM.MLPMappingConfig(prefix_length=2, embed_dim=8, gpt_dim=32),
        eos_token_id=5,
    )

    class Tok:
        def batch_decode(self, ids, skip_special_tokens=True):
            return [" ".join(str(i) for i in row if i != 5) for row in ids]

    model = TC.ImageCaptioningModel(cfg, tokenizer=Tok(),
                                    generator=torch.Generator().manual_seed(1), device="cpu")
    emb = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    tr, fz, pol = model.decode_params("bf16")
    assert fz["gpt"]["wte"].dtype == torch.bfloat16 and pol.compute_dtype == torch.bfloat16
    assert model.decode_params("bf16")[0] is tr
    ids = model.generate(emb, max_length=6, temperature=0.0, decode_precision="bf16")
    assert ids.shape == (3, 6) and ids.dtype == torch.int32
    caps = model.generate_captions(emb, max_length=6, temperature=0.0)
    assert len(caps) == 3 and all(isinstance(c, str) for c in caps)
    in_kernel = TC.generate(tr, fz, cfg, torch.from_numpy(emb), max_length=6, temperature=1.0,
                            sample_in_kernel=True, policy=pol)
    assert in_kernel.shape == (3, 6) and in_kernel.dtype == torch.int32
    ids8 = model.generate(emb, max_length=6, temperature=0.0, decode_precision="int8")
    assert torch.equal(ids8, TC.generate(tr, fz, cfg, torch.from_numpy(emb), max_length=6,
                                         temperature=0.0, policy=pol, decode_quant=True))
    with pytest.raises(NotImplementedError, match="queue 1: tensor parallelism"):
        model.generate(emb, temperature=0.0, mesh=TP2)
    # a one-rank mesh decodes as no mesh does, bit for bit, greedy and sampled
    one = create_mesh(device="cpu")
    for t in (0.0, 1.0):
        assert torch.equal(model.generate(emb, max_length=6, temperature=t),
                           model.generate(emb, max_length=6, temperature=t, mesh=one))
    beams = TC.beam_generate(tr, fz, cfg, torch.from_numpy(emb), max_length=6, beam_size=4,
                             policy=pol)
    assert beams.shape == (3, 6) and beams.dtype == torch.int32
    with pytest.raises(ValueError, match="CUDA"):
        model.generate(emb, temperature=0.0, use_kernels=True)
    assert dataclasses.replace(cfg, eos_token_id=1).total_prefix_length == 2


def _teacher_forced_logits(tr, fz, cfg, emb, tokens):
    """The JAX model's float32 logits at every step, fed ``tokens``:
    (steps, B, V), step s predicting token s."""
    gp, gcfg = fz["gpt"], cfg.gpt2
    prefix = JC.build_prefix(tr, cfg, jnp.asarray(emb))
    cache = JG.init_cache(gcfg, prefix.shape[0], prefix.shape[1] + tokens.shape[1])
    logits, cache = JG.forward_cached(gp, gcfg, prefix, cache, fresh_prefill=True)
    out = [np.asarray(logits)]
    for s in range(1, tokens.shape[1]):
        emb_t = JG.embed_tokens(gp, jnp.asarray(tokens[:, s - 1 : s]))
        logits, cache = JG.forward_cached(gp, gcfg, emb_t, cache, use_pallas_decode=False)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("case", ["one_row_stops", "early_exit"])
def test_sampled_with_a_one_token_nucleus_is_greedy_and_matches_jax(case):
    """top_p = 1e-6 keeps each row's top-1 alone, so sampled decoding is
    greedy decoding whatever the draws: the port's sampled tokens equal its
    greedy tokens and the JAX package's sampled tokens."""
    jcfg, tcfg, tr, fz, emb = _models(case)
    kw = dict(max_length=MAX_LEN, temperature=1.0, top_p=1e-6)
    want = np.asarray(JC.generate(tr, fz, jcfg, jnp.asarray(emb), rng=jax.random.PRNGKey(5),
                                  use_pallas_decode=False, **kw))
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    got = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb),
                      generator=torch.Generator().manual_seed(5), **kw)
    greedy = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                         temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(got, greedy, rtol=0, atol=0)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sampled_tokens_lie_in_the_jax_nucleus(temperature):
    """At top_p = 0.9 every token the port draws (until its row's EOS) lies in
    the nucleus the JAX package computes on the port's own prefix, teacher
    forced; and the draws are not all the argmax."""
    jcfg, tcfg, tr, fz, emb = _models("one_row_stops")
    jcfg = dataclasses.replace(jcfg, eos_token_id=292)
    tcfg = dataclasses.replace(tcfg, eos_token_id=292)
    emb = np.random.default_rng(3).normal(size=(16, 16)).astype(np.float32)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    got = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                      temperature=temperature, top_p=0.9,
                      generator=torch.Generator().manual_seed(11)).numpy()
    logits = _teacher_forced_logits(tr, fz, jcfg, emb, got)
    alive = np.ones(len(got), bool)
    argmax_hits = checked = 0
    for s in range(MAX_LEN):
        lg = logits[s] / temperature
        kept = np.asarray(JS.top_p_filter_bisect(jnp.asarray(lg), 0.9)) != float(JS.NEG_INF)
        tok = got[:, s]
        assert kept[np.arange(len(got)), tok][alive].all(), f"step {s}"
        argmax_hits += int((tok == lg.argmax(axis=1))[alive].sum())
        checked += int(alive.sum())
        alive &= tok != jcfg.eos_token_id
    assert argmax_hits < checked


def test_facade_generate_runs_with_its_defaults():
    """``ImageCaptioningModel.generate(emb)`` samples at the JAX façade's
    defaults (temperature 1.0, top_p 0.9, 50 tokens) with a generator seeded
    with 0; the same seed gives the same tokens, another seed others."""
    cfg = TC.CaptionerConfig(
        gpt2=TG.GPT2Config.tiny(),
        mapping=TM.MLPMappingConfig(prefix_length=2, embed_dim=8, gpt_dim=32),
        eos_token_id=292,
    )
    model = TC.ImageCaptioningModel(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    emb = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    ids = model.generate(emb)
    assert ids.shape == (3, 50) and ids.dtype == torch.int32
    torch.testing.assert_close(model.generate(emb), ids, rtol=0, atol=0)
    same = model.generate(emb, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(same, ids, rtol=0, atol=0)
    other = model.generate(emb, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(other, ids)
    greedy = model.generate(emb, temperature=0.0)
    assert not torch.equal(greedy, ids)
