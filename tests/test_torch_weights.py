"""The weight bridge: JAX param trees → port → numpy, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.core.precision import cast_floating as j_cast
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

MAPPINGS = {
    "mlp": (JM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32),
            TM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32)),
    "transformer": (
        JM.TransformerMappingConfig(16, 32, 5, 4, num_layers=2, num_heads=4),
        TM.TransformerMappingConfig(16, 32, 5, 4, num_layers=2, num_heads=4),
    ),
}


def _configs(kind, freeze=True):
    jm, tm = MAPPINGS[kind]
    return (JC.CaptionerConfig(gpt2=JG.GPT2Config.tiny(), mapping=jm, freeze_gpt_weights=freeze),
            TC.CaptionerConfig(gpt2=TG.GPT2Config.tiny(), mapping=tm, freeze_gpt_weights=freeze))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen_gpt", "trainable_gpt"])
@pytest.mark.parametrize("kind", list(MAPPINGS))
def test_round_trip_is_bit_equal(kind, freeze):
    jcfg, tcfg = _configs(kind, freeze)
    tr, fz = JC.init_params(jax.random.PRNGKey(0), jcfg)
    tr_np, fz_np = jax.tree.map(np.asarray, (tr, fz))
    ttr, tfz = porting.from_jax_numpy(tr_np, fz_np, tcfg, device="cpu")
    assert ("gpt" in tfz) == freeze and "mapping" in ttr
    assert isinstance(ttr["mapping"], dict)
    back_tr, back_fz = porting.to_numpy(ttr, tfz)
    for want, got in ((tr_np, back_tr), (fz_np, back_fz)):
        wl, gl = _leaves(want), _leaves(got)
        assert [p for p, _ in wl] == [p for p, _ in gl]
        for (path, a), (_, b) in zip(wl, gl):
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=str(path))


def test_bf16_leaves_cross_bit_for_bit():
    jcfg, tcfg = _configs("mlp")
    tr, fz = JC.init_params(jax.random.PRNGKey(1), jcfg)
    tr_np, fz_np = jax.tree.map(np.asarray, (j_cast(tr), j_cast(fz)))
    ttr, tfz = porting.from_jax_numpy(tr_np, fz_np, tcfg, device="cpu")
    a = fz_np["gpt"]["blocks"]["attn"]["c_attn"]["w"]
    t = tfz["gpt"]["blocks"]["attn"]["c_attn"]["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    _, back = porting.to_numpy(ttr, tfz)
    np.testing.assert_array_equal(back["gpt"]["wte"], fz_np["gpt"]["wte"].astype(np.float32))


def test_dtype_cast_and_shape_check():
    jcfg, tcfg = _configs("mlp")
    tr, fz = jax.tree.map(np.asarray, JC.init_params(jax.random.PRNGKey(0), jcfg))
    _, tfz = porting.from_jax_numpy(tr, fz, tcfg, device="cpu", dtype=torch.bfloat16)
    assert tfz["gpt"]["wte"].dtype == torch.bfloat16
    wrong = TC.CaptionerConfig(gpt2=TG.GPT2Config.tiny(vocab_size=300), mapping=tcfg.mapping)
    with pytest.raises(ValueError, match="do not match"):
        porting.from_jax_numpy(tr, fz, wrong, device="cpu")


@pytest.mark.parametrize("kind", list(MAPPINGS))
def test_torch_init_params_has_the_jax_tree(kind):
    """The torch-native init builds the same trees, shapes and dtypes."""
    jcfg, tcfg = _configs(kind)
    jtr, jfz = JC.init_params(jax.random.PRNGKey(0), jcfg)
    ttr, tfz = TC.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))  # noqa: E731
    assert jax.tree.map(shape, (ttr, tfz)) == jax.tree.map(shape, (jtr, jfz))
    assert jnp.float32 == jfz["gpt"]["wte"].dtype
