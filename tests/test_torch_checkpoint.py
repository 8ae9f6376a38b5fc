"""Captioner checkpoints cross between the port and the JAX package: a
``.pt`` (the reference's names) or ``.npz`` saved by one loads in the other
and back, for both mappers, with a task prompt and with GPT-2 trainable.
Values must survive bit for bit (float32 throughout)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu.train import checkpoint as JK
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.train import checkpoint as TK

MAPPINGS = {
    "mlp": (JM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32),
            TM.MLPMappingConfig(prefix_length=3, embed_dim=16, gpt_dim=32)),
    "transformer": (JM.TransformerMappingConfig(16, 32, 5, 4, num_layers=2, num_heads=4),
                    TM.TransformerMappingConfig(16, 32, 5, 4, num_layers=2, num_heads=4)),
}


def _setup(kind, **kw):
    jm, tm = MAPPINGS[kind]
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config.tiny(), mapping=jm, **kw)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config.tiny(), mapping=tm, **kw)
    tr, fz = JC.init_params(jax.random.PRNGKey(0), jcfg)
    # the port's own tree, from other weights, is what a load overwrites
    other, _ = TC.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    ttr, _ = porting.from_jax_numpy(*jax.tree.map(np.asarray, (tr, fz)), tcfg, device="cpu")
    return jcfg, tcfg, tr, ttr, other


def _assert_equal(torch_tree, jax_tree):
    got = {k: v.numpy() for k, v in flatten_with_paths(torch_tree).items()}
    want = flatten_with_paths(jax.tree.map(np.asarray, jax_tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


VARIANTS = {
    "mlp": ("mlp", {}),
    "transformer": ("transformer", {}),
    "task_prompt": ("transformer", {"task_prompt_ids": (5, 17)}),
    "gpt_trainable": ("mlp", {"freeze_gpt_weights": False}),
}


@pytest.mark.parametrize("ext", ["pt", "npz"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkpoint_crosses_both_ways(tmp_path, variant, ext):
    kind, kw = VARIANTS[variant]
    jcfg, tcfg, tr, ttr, other = _setup(kind, **kw)
    ours = str(tmp_path / f"port.{ext}")
    TK.save_captioner(ours, ttr, tcfg)
    _assert_equal(ttr, JK.load_captioner(ours, tr, jcfg))  # the port's file, in JAX
    theirs = str(tmp_path / f"jax.{ext}")
    JK.save_captioner(theirs, tr, jcfg)
    _assert_equal(TK.load_captioner(theirs, other, tcfg), tr)  # JAX's file, in the port
    _assert_equal(TK.load_captioner(ours, other, tcfg), tr)  # and back
    if ext == "pt":
        sd = torch.load(ours, weights_only=True)
        assert set(sd) == set(torch.load(theirs, weights_only=False))
        assert all(k.startswith(("mapping_network.", "task_prefix_embeds", "gpt.")) for k in sd)


def test_load_refuses_foreign_or_missing_keys(tmp_path):
    jcfg, tcfg, tr, ttr, other = _setup("mlp")
    path = str(tmp_path / "x.pt")
    sd = porting.export_mlp_mapping(ttr["mapping"])
    torch.save(dict(sd, stray=torch.zeros(1)), path)
    with pytest.raises(ValueError, match="Unexpected keys"):
        TK.load_captioner(path, other, tcfg)
    prompt_cfg = dataclasses.replace(tcfg, task_prompt_ids=(1, 2))
    torch.save(sd, path)
    with pytest.raises(ValueError, match="task_prefix_embeds"):
        TK.load_captioner(path, dict(other, task_prefix=torch.zeros(2, 32)), prompt_cfg)
    npz = str(tmp_path / "x.npz")
    TK.save_captioner(npz, {"mapping": ttr["mapping"]["fc1"]}, tcfg)
    with pytest.raises(ValueError, match="keys"):
        TK.load_captioner(npz, other, tcfg)
