"""Package-level properties of the port: it never loads jax, and it never
quietly runs the plain path when the kernels were asked for."""

import subprocess
import sys
import threading
import time

import pytest
import torch

from gpt2_image_captioning_tpu_torch.evaluation import generation
from gpt2_image_captioning_tpu_torch.models import captioner as C
from gpt2_image_captioning_tpu_torch.models import gpt2 as G
from gpt2_image_captioning_tpu_torch.models import mapping as M
from gpt2_image_captioning_tpu_torch.ops import _build
from gpt2_image_captioning_tpu_torch.ops import decode_attention as DA
from gpt2_image_captioning_tpu_torch.ops import decode_step as DS
from gpt2_image_captioning_tpu_torch.train import loop


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
        "from gpt2_image_captioning_tpu_torch.data import native_bpe\n"
        "from gpt2_image_captioning_tpu_torch.core import logging\n"
        "from gpt2_image_captioning_tpu_torch import evaluation, utils\n"
        "from gpt2_image_captioning_tpu_torch.evaluation import evaluate, generation, metrics\n"
        "from gpt2_image_captioning_tpu_torch.core import config\n"
        "from gpt2_image_captioning_tpu_torch import sweep, training_pipeline, viz\n"
        "from gpt2_image_captioning_tpu_torch import __main__ as cli\n"
        "from gpt2_image_captioning_tpu_torch.viz import __main__ as viz_cli, server\n"
        "from gpt2_image_captioning_tpu_torch.serving import serve_http, serve_http_continuous\n"
        "from gpt2_image_captioning_tpu_torch.retrieval import exact, hnsw, indexing\n"
        "from gpt2_image_captioning_tpu_torch.retrieval import rat_pipeline, store\n"
        "from gpt2_image_captioning_tpu_torch.models import rat\n"
        "from gpt2_image_captioning_tpu_torch.embeddings import word_embeddings\n"
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


def test_epoch_loop_and_evaluation_default_to_the_card():
    """``train`` and ``evaluate_epoch`` run on "cuda" unless given
    ``device="cpu"``: without a card they raise before any work."""
    cfg = C.CaptionerConfig(gpt2=G.GPT2Config(vocab_size=40, n_positions=16, n_embd=8, n_layer=1,
                                              n_head=2),
                            mapping=M.MLPMappingConfig(prefix_length=2, embed_dim=4, gpt_dim=8),
                            eos_token_id=39)
    model = C.ImageCaptioningModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(None, model, batch_size=2, num_epochs=1, outputs_dir="unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generation.evaluate_epoch(model, None, "unused.json", epoch=1, split_name="val")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generation.generate_predictions(model, None)


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


def test_first_build_runs_once_across_threads(monkeypatch, tmp_path):
    """Threads that call ``library()`` first at once (a server's dispatcher
    and the main thread) build once: the others wait for the first and load
    its library, rather than running nvcc into the same object files."""
    lib_path = tmp_path / "libgic_kernels.so"
    state = {"compiles": 0, "inside": 0, "most_inside": 0}

    def fake_build():
        state["inside"] += 1
        state["most_inside"] = max(state["most_inside"], state["inside"])
        if not lib_path.exists():  # as build(): compile unless this source set is built
            time.sleep(0.2)
            state["compiles"] += 1
            lib_path.write_bytes(b"")
        state["inside"] -= 1
        return lib_path

    class FakeFn:
        pass

    class FakeLib:
        def __getattr__(self, name):
            fn = FakeFn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build.library.cache_clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        threads = [threading.Thread(target=lambda: got.append(_build.library())) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 8 and all(isinstance(lib, FakeLib) for lib in got)
        assert state["compiles"] == 1 and state["most_inside"] == 1
        assert got[0].gic_decode_attention.restype is _build.ctypes.c_int
    finally:
        sys.setswitchinterval(interval)
        _build.library.cache_clear()
