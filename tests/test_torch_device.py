"""Where the port runs: every public entry point defaults to the card and,
with no card, raises instead of running on the CPU; ``use_kernels=False``
reaches every attention call of ``generate`` and ``loss_fn``."""

import inspect
import sys

import numpy as np
import pytest
import torch

from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting
from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.train import loop as TL
from gpt2_image_captioning_tpu_torch.train import optim as TO

CFG = TC.CaptionerConfig(gpt2=TG.GPT2Config.tiny(),
                         mapping=TM.TransformerMappingConfig(8, 32, 3, 2, num_layers=2,
                                                             num_heads=4),
                         eos_token_id=292)
ENTRY_POINTS = {
    "init_params": TC.init_params,
    "ImageCaptioningModel": TC.ImageCaptioningModel.__init__,
    "from_jax_numpy": porting.from_jax_numpy,
    "make_train_step": TL.make_train_step,
    "init_cache": TG.init_cache,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    calls = {
        "init_params": lambda: TC.init_params(gen, CFG),
        "ImageCaptioningModel": lambda: TC.ImageCaptioningModel(CFG, generator=gen),
        "from_jax_numpy": lambda: porting.from_jax_numpy({}, {}, CFG),
        "make_train_step": lambda: TL.make_train_step(CFG, TO.AdamWConfig(), TC.F32),
        "init_cache": lambda: TG.init_cache(CFG.gpt2, 2, 8),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[name]()


def _spy(monkeypatch) -> list:
    """Record the ``use_kernel`` flag of every attention dispatch, and of the
    prefill's (whose kernel holds the prefill's attention)."""
    seen, real = [], _build.kernels_enabled

    def spy(use_kernel, device):
        if sys._getframe(1).f_code.co_name in ("mha", "fused_prefill"):
            seen.append(use_kernel)
        return real(use_kernel, device)

    monkeypatch.setattr(_build, "kernels_enabled", spy)
    return seen


def _batch():
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 293, size=(2, 5)))
    return {"token_ids": tokens, "labels": tokens.clone(),
            "attention_mask": torch.ones(2, 5, dtype=torch.int32),
            "image_embedding": torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))}


@pytest.mark.parametrize("flag", [None, False])
def test_use_kernels_reaches_every_attention(flag, monkeypatch):
    """Two mapper layers and two GPT-2 layers: four attention dispatches in
    ``loss_fn``, and in ``generate`` two in the mapper and one for the
    prefill (its kernel runs every layer's attention), each with the
    caller's flag (``generate`` resolves None for CPU inputs to False
    first)."""
    tr, fz = TC.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    seen = _spy(monkeypatch)
    TC.loss_fn(tr, fz, CFG, _batch(), use_kernels=flag)
    assert seen == [flag] * 4
    seen.clear()
    TC.generate(tr, fz, CFG, _batch()["image_embedding"], max_length=3, temperature=0.0,
                use_kernels=flag)
    assert seen == [False] * 3
    with pytest.raises(ValueError, match="CUDA tensors"):
        TC.loss_fn(tr, fz, CFG, _batch(), use_kernels=True)
