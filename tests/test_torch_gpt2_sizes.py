"""The GPT-2 family sizes beyond 124M in the port against the JAX package:
the constructors, the plain forward and greedy ``generate`` at the widths of
medium, large and XL (D 1024 / 1280 / 1600, heads of 64; one layer and a
211-token vocabulary keep them CPU-sized), and ``gpt_params`` — a GPT-2 tree
given to ``init_params`` in place of the random one."""

import jax
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

SIZES = ["gpt2_124m", "gpt2_medium", "gpt2_large", "gpt2_xl"]
WIDE = {"gpt2_medium": (1024, 16), "gpt2_large": (1280, 20), "gpt2_xl": (1600, 25)}
VOCAB = 211


@pytest.mark.parametrize("name", SIZES)
def test_constructors_match_jax(name):
    got, want = getattr(TG.GPT2Config, name)(), getattr(JG.GPT2Config, name)()
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert got.head_dim == want.head_dim == 64


def _configs(name, n_layer=1):
    d, h = WIDE[name]
    gkw = dict(vocab_size=VOCAB, n_positions=32, n_embd=d, n_layer=n_layer, n_head=h)
    mkw = dict(prefix_length=3, embed_dim=24, gpt_dim=d)
    return (JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                               eos_token_id=VOCAB - 1),
            TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                               eos_token_id=VOCAB - 1))


@pytest.fixture(scope="module", params=sorted(WIDE))
def wide(request):
    """(name, JAX config, port config, JAX trees, port trees) of one width."""
    jcfg, tcfg = _configs(request.param)
    jtr, jfz = JC.init_params(jax.random.PRNGKey(1), jcfg)
    tr, fz = porting.from_jax_numpy(*jax.tree.map(np.asarray, (jtr, jfz)), tcfg, device="cpu")
    return request.param, jcfg, tcfg, (jtr, jfz), (tr, fz)


def test_wide_forward_matches_jax(wide):
    """The plain full-sequence forward at the size's width: logits within
    1e-4 of the JAX package's."""
    _, jcfg, tcfg, (_, jfz), (_, fz) = wide
    x = np.random.default_rng(0).normal(size=(2, 7, tcfg.gpt2.n_embd)).astype(np.float32) * 0.1
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    want = np.asarray(JG.forward(jfz["gpt"], jcfg.gpt2, x, mask))
    got = TG.forward(fz["gpt"], tcfg.gpt2, torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wide_generate_matches_jax(wide):
    """Greedy tokens at the size's width equal the JAX package's (which
    decodes these widths on its XLA path), 8 tokens for 3 images."""
    _, jcfg, tcfg, (jtr, jfz), (tr, fz) = wide
    emb = np.random.default_rng(3).normal(size=(3, 24)).astype(np.float32)
    want = np.asarray(JC.generate(jtr, jfz, jcfg, emb, max_length=8, temperature=0.0))
    got = TC.generate(tr, fz, tcfg, torch.from_numpy(emb), max_length=8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("freeze", [True, False])
def test_gpt_params_replace_the_random_gpt2(freeze):
    """``gpt_params`` (a JAX GPT-2 carried across) is the model's GPT-2, the
    task prefix is its wte rows as in the JAX package, the mapper is the
    generator's either way, and an unfrozen tree is a copy the train step
    may change in place; a tree of another size is refused."""
    jcfg, tcfg = _configs("gpt2_medium")
    jcfg = JC.CaptionerConfig(gpt2=jcfg.gpt2, mapping=jcfg.mapping, task_prompt_ids=(5, 9, 5),
                              freeze_gpt_weights=freeze, eos_token_id=VOCAB - 1)
    tcfg = TC.CaptionerConfig(gpt2=tcfg.gpt2, mapping=tcfg.mapping, task_prompt_ids=(5, 9, 5),
                              freeze_gpt_weights=freeze, eos_token_id=VOCAB - 1)
    jgpt = JG.init(jax.random.PRNGKey(7), jcfg.gpt2)
    gpt = porting.from_jax_numpy({}, {"gpt": jax.tree.map(np.asarray, jgpt)}, tcfg,
                                 device="cpu")[1]["gpt"]
    jtr, jfz = JC.init_params(jax.random.PRNGKey(2), jcfg, gpt_params=jgpt)
    tr, fz = TC.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu", gpt_params=gpt)
    np.testing.assert_array_equal(tr["task_prefix"].numpy(), np.asarray(jtr["task_prefix"]))
    held = fz["gpt"] if freeze else tr["gpt"]
    assert ("gpt" in fz) == freeze and ("gpt" in tr) != freeze
    np.testing.assert_array_equal(held["wte"].numpy(), np.asarray(jgpt["wte"]))
    assert (held["wte"] is gpt["wte"]) == freeze  # frozen trees are shared, unfrozen copied
    tr_random, _ = TC.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    torch.testing.assert_close(tr["mapping"], tr_random["mapping"], rtol=0, atol=0)
    model = TC.ImageCaptioningModel(tcfg, device="cpu", gpt_params=gpt)
    assert torch.equal(TC._gpt(model.trainable, model.frozen)["wpe"], gpt["wpe"])
    _, small = _configs("gpt2_large")
    with pytest.raises(ValueError, match="do not match"):
        TC.init_params(torch.Generator(), small, device="cpu", gpt_params=gpt)
