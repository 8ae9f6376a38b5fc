"""The port's ``beam_generate`` against the JAX package's, token for token in
float32 at a tiny config, through both JAX beam paths: the XLA path that
gathers the cache every step, and the beam-aware step kernel (ancestry map +
in-kernel top-k) in interpret mode.  The port runs its plain twins here.

The position embeddings are scaled by 8 so that rows share tokens late in
the caption while the beams still part from the greedy path; EOS 208 is a
token several beams reach at step 4-5, so beams finish early and are padded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

MAX_LEN, EOS = 8, 208


def _models():
    gkw = dict(vocab_size=293, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=16, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=EOS)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=EOS)
    tr, fz = JC.init_params(jax.random.PRNGKey(3), jcfg)
    fz = dict(fz, gpt=dict(fz["gpt"], wpe=fz["gpt"]["wpe"] * 8.0))
    emb = np.random.default_rng(9).normal(size=(4, 16)).astype(np.float32)
    ttr, tfz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return jcfg, tcfg, tr, fz, ttr, tfz, emb


def _jax_beams(jcfg, tr, fz, emb, path, **kw):
    if path == "xla":
        return np.asarray(JC.beam_generate(tr, fz, jcfg, jnp.asarray(emb), use_pallas_decode=False,
                                           **kw))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(JC.beam_generate(tr, fz, jcfg, jnp.asarray(emb), use_pallas_decode=True,
                                           **kw))


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
@pytest.mark.parametrize("jax_path", ["xla", "fused_interpret"])
@pytest.mark.parametrize("beam_size", [2, 4])
def test_beam_tokens_match_jax(beam_size, jax_path, length_penalty):
    jcfg, tcfg, tr, fz, ttr, tfz, emb = _models()
    kw = dict(max_length=MAX_LEN, beam_size=beam_size, length_penalty=length_penalty)
    want = _jax_beams(jcfg, tr, fz, emb, jax_path, **kw)
    got = TC.beam_generate(ttr, tfz, tcfg, torch.from_numpy(emb), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_size_one_is_greedy():
    """One beam keeps the argmax at every step: the greedy tokens, with the
    same EOS padding (greedy stops early, the beam runs on EOS)."""
    jcfg, tcfg, tr, fz, ttr, tfz, emb = _models()
    greedy = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                         temperature=0.0)
    beam = TC.beam_generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                            beam_size=1)
    torch.testing.assert_close(beam, greedy, rtol=0, atol=0)
    np.testing.assert_array_equal(beam.numpy(), _jax_beams(jcfg, tr, fz, emb, "xla",
                                                           max_length=MAX_LEN, beam_size=1))


def test_beam_output_is_fixed_width_and_eos_padded():
    """(B, max_length) int32 ids, EOS after each row's first EOS
    (PARITY.md:73-76), with some row finished before the last position and
    the beams apart from the greedy path."""
    _, tcfg, _, _, ttr, tfz, emb = _models()
    out = TC.beam_generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                           beam_size=4).numpy()
    assert out.shape == (4, MAX_LEN) and out.dtype == np.int32
    early = 0
    for row in out:
        hits = np.flatnonzero(row == EOS)
        if hits.size:
            assert (row[hits[0]:] == EOS).all()
            early += int(hits[0] < MAX_LEN - 1)
    assert early >= 1
    greedy = TC.generate(ttr, tfz, tcfg, torch.from_numpy(emb), max_length=MAX_LEN,
                         temperature=0.0).numpy()
    assert (out != greedy).any()


def test_beam_refusals():
    _, tcfg, _, _, ttr, tfz, emb = _models()
    x = torch.from_numpy(emb)
    with pytest.raises(NotImplementedError, match="parallelism"):
        TC.beam_generate(ttr, tfz, tcfg, x, mesh=object())
    int8 = TC.beam_generate(ttr, tfz, tcfg, x, max_length=MAX_LEN, decode_quant=True)
    packed = TC.prepare_decode_weights(ttr, tfz, tcfg, quant=True)
    assert torch.equal(int8, TC.beam_generate(ttr, tfz, tcfg, x, max_length=MAX_LEN,
                                              decode_quant=True, packed=packed))
    with pytest.raises(ValueError, match="decode_quant=False needs a pack with quant=False"):
        TC.beam_generate(ttr, tfz, tcfg, x, packed=packed)
    with pytest.raises(ValueError, match="CUDA"):
        TC.beam_generate(ttr, tfz, tcfg, x, use_kernels=True)
