"""The port's command lines: ``python -m gpt2_image_captioning_tpu_torch``
(the environment check) answers ``--help`` without loading jax or touching
CUDA, and exits 1 without a card after reporting what it found; the
pipeline, the sweep, the viewer and the extraction CLI answer ``--help``;
the extraction CLI writes the JAX package's CLI's ``.pt`` on the same
images and checkpoint."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(*args, code=None, timeout=120):
    cmd = [sys.executable, *(["-c", code] if code else []), *args]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_help_leaves_jax_and_cuda_untouched():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['gpt2_image_captioning_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('gpt2_image_captioning_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.startswith('gpt2_image_captioning_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    proc = run(code=code)
    assert proc.returncode == 0, proc.stderr
    assert "Environment check" in proc.stdout and proc.stdout.strip().endswith("clean")
    assert "for the current sources" not in proc.stdout  # the check itself did not run


def test_check_exits_1_without_a_card():
    proc = run("-m", "gpt2_image_captioning_tpu_torch")
    assert proc.returncode == 1
    out = proc.stdout
    assert out.startswith("torch ") and "no CUDA device visible" in out
    assert "kernel library for the current sources:" in out and "nvcc:" in out
    assert "native image pipeline:" in out and "native BPE engine:" in out
    assert "GPT-2 tokenizer in assets/gpt2:" in out
    assert "runs on a CUDA device" in proc.stderr


def test_check_names_the_tokenizer_dir(tmp_path):
    (tmp_path / "vocab.json").write_text("{}")
    env = dict(os.environ, GPT2_TOKENIZER_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "gpt2_image_captioning_tpu_torch"],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert f"GPT-2 tokenizer in {tmp_path}: present" in proc.stdout


def test_check_rejects_arguments():
    proc = run("-m", "gpt2_image_captioning_tpu_torch", "--bogus")
    assert proc.returncode == 2 and "unrecognized arguments" in proc.stderr


@pytest.mark.parametrize("module, options", [
    ("gpt2_image_captioning_tpu_torch.training_pipeline", ("--config", "--save-dir")),
    ("gpt2_image_captioning_tpu_torch.sweep", ("--automation", "--only", "--output-dir")),
    ("gpt2_image_captioning_tpu_torch.viz", ("--predictions", "--compute-metrics")),
    ("gpt2_image_captioning_tpu_torch.embeddings.extract",
     ("--encoder", "--image-dir", "--output", "--checkpoint", "--batch-size", "--num-workers",
      "--device-chunks", "--device")),
])
def test_entry_points_answer_help(module, options):
    proc = run("-m", module, "--help")
    assert proc.returncode == 0 and all(o in proc.stdout for o in options), proc.stdout


def test_extraction_cli_matches_jax(tmp_path):
    """One command line, both packages: ``--encoder clip`` over four PNGs
    with a ``--checkpoint`` saved from a random-init HF CLIP ViT-B/32
    vision tower (bf16, the CLIs' policy).  The ``.pt`` files hold the same
    names and features within the bf16 towers' tolerance (1e-2,
    ``tests/test_torch_vision.py``); the port's run never imports jax."""
    import numpy as np
    import torch
    import transformers
    from PIL import Image
    from safetensors.torch import save_file

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, size=(48 + 9 * i, 40, 3), dtype=np.uint8)).save(
            images / f"COCO_val2017_{i:012d}.png")
    torch.manual_seed(0)
    tower = transformers.CLIPVisionModelWithProjection(transformers.CLIPVisionConfig(
        projection_dim=512, attention_dropout=0.0))
    ckpt = str(tmp_path / "clip_vision.safetensors")
    save_file({k: v.contiguous().clone() for k, v in tower.state_dict().items()}, ckpt)
    common = ["--encoder", "clip", "--image-dir", str(images), "--checkpoint", ckpt,
              "--batch-size", "4", "--num-workers", "1", "--device-chunks", "2"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = {}
    for name, module, extra in (
            ("jax", "gpt2_image_captioning_tpu.embeddings.extract", []),
            ("port", "gpt2_image_captioning_tpu_torch.embeddings.extract", ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.pt")
        code = ("import runpy, sys\n"
                f"sys.argv = ['extract'] + {common + ['--output', outs[name]] + extra!r}\n"
                f"runpy.run_module({module!r}, run_name='__main__')\n"
                "print('jax imported' if 'jax' in sys.modules else 'jax absent')\n")
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=300, cwd=REPO, env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        if name == "port":
            assert proc.stdout.strip().endswith("jax absent")
    jax_out = torch.load(outs["jax"], weights_only=False)
    port_out = torch.load(outs["port"], weights_only=False)
    assert port_out["filenames"] == jax_out["filenames"] == sorted(
        p.name for p in images.iterdir())
    want, got = np.asarray(jax_out["embeddings"]), np.asarray(port_out["embeddings"])
    assert got.shape == want.shape == (4, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-2)
