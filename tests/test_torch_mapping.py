"""The port's mapping networks against the JAX package's, in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch.models import mapping as TM

CONFIGS = {
    "mlp": (JM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32),
            TM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32)),
    "transformer": (
        JM.TransformerMappingConfig(embed_dim=16, gpt_dim=32, prefix_length=5, hidden_length=4,
                                    num_layers=2, num_heads=4),
        TM.TransformerMappingConfig(embed_dim=16, gpt_dim=32, prefix_length=5, hidden_length=4,
                                    num_layers=2, num_heads=4),
    ),
}


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_mapping_matches_jax(kind):
    jcfg, tcfg = CONFIGS[kind]
    params = JM.init_mapping(jax.random.PRNGKey(0), jcfg)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    x = np.random.default_rng(2).normal(size=(5, 16)).astype(np.float32)
    want = JM.apply_mapping(params, jcfg, jnp.asarray(x))
    got = TM.apply_mapping(tparams, tcfg, torch.from_numpy(x))
    assert tuple(got.shape) == (5, jcfg.prefix_length, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_init_has_the_jax_tree(kind):
    jcfg, tcfg = CONFIGS[kind]
    jp = JM.init_mapping(jax.random.PRNGKey(0), jcfg)
    tp = TM.init_mapping(torch.Generator().manual_seed(0), tcfg)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes


def test_make_mapping_config():
    block = {"type": "transformer", "embed_dim": 512, "gpt_dim": 768, "prefix_length": 15,
             "hidden_length": 10}
    assert TM.make_mapping_config(block) == TM.TransformerMappingConfig(512, 768, 15, 10)
    assert TM.make_mapping_config({"type": "mlp", "prefix_length": 10, "embed_dim": 512,
                                   "gpt_dim": 768}).type == "mlp"
    with pytest.raises(ValueError):
        TM.make_mapping_config({"type": "conv"})
