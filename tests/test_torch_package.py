"""Package-level properties of the port: it never loads jax, and it never
quietly runs the plain path when the kernels were asked for."""

import subprocess
import sys

import pytest
import torch

from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS


def test_import_leaves_jax_out():
    code = (
        "import sys, gpt2_image_captioning_tpu_torch as p\n"
        "from gpt2_image_captioning_tpu_torch.models import captioner, porting\n"
        "from gpt2_image_captioning_tpu_torch.ops import attention, decode_step, xent, _build\n"
        "from gpt2_image_captioning_tpu_torch.train import checkpoint, loop, optim\n"
        "from gpt2_image_captioning_tpu_torch.data import dataset, tokenizer\n"
        "from gpt2_image_captioning_tpu_torch.models import continuous\n"
        "from gpt2_image_captioning_tpu_torch import serving\n"
        "from gpt2_image_captioning_tpu_torch.models import clip, dino, vit\n"
        "from gpt2_image_captioning_tpu_torch.ops import patch_embed, prefill_step\n"
        "from gpt2_image_captioning_tpu_torch.embeddings import extract, preprocess\n"
        "from gpt2_image_captioning_tpu_torch.data import embeddings_io, images, native_pipe\n"
        "assert 'PIL' not in sys.modules, 'PIL is imported where an image is decoded'\n"
        "jax_pkg = 'gpt2_image_captioning_tpu'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == jax_pkg or m.startswith(jax_pkg + '.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_kernels_on_cpu_raise():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DS.fused_linear(x, torch.zeros(4, 8), torch.zeros(4), epilogue="cast", use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DS.logits_argmax(x, torch.zeros(2, 8), torch.zeros(5, 8), use_kernel=True)
    kc = torch.zeros(16, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DA.decode_attention(x, x, x, kc, kc.clone(), 0, n_head=2, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        DS.fused_decode_step({}, x, kc[None], kc[None], 0, n_head=2, use_kernels=True)
    # the CUDA wrappers themselves refuse CPU tensors before touching the build
    with pytest.raises(ValueError, match="CUDA tensor"):
        DA.decode_attention_cuda(x, x, x, kc, kc, 0, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        DS.fused_linear_cuda(x, torch.zeros(4, 8), torch.zeros(4), epilogue="cast")
    with pytest.raises(ValueError, match="CUDA tensor"):
        DS.logits_argmax_cuda(x, torch.zeros(2, 8), torch.zeros(5, 8))


@pytest.mark.parametrize("flag, want", [(None, False), (False, False)])
def test_dispatch_on_cpu(flag, want):
    assert _build.kernels_enabled(flag, torch.device("cpu")) is want
    assert _build.kernels_enabled(False, torch.device("cuda")) is False
    assert _build.kernels_enabled(None, torch.device("cuda")) is True
    assert DS.fused_greedy_enabled(None, "cpu") is False


def test_build_key_covers_every_source():
    names = {p.name for p in _build._sources()}
    assert {"decode_attention.cu", "fused_linear.cu", "logits_argmax.cu", "flash_attention.cu",
            "logits_sample.cu", "common.cuh"} <= names
    assert len(_build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
