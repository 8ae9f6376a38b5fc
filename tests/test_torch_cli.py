"""The port's command lines: ``python -m gpt2_image_captioning_tpu_torch``
(the environment check) answers ``--help`` without loading jax or touching
CUDA, and exits 1 without a card after reporting what it found; the
pipeline, the sweep and the viewer answer ``--help``."""

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
])
def test_entry_points_answer_help(module, options):
    proc = run("-m", module, "--help")
    assert proc.returncode == 0 and all(o in proc.stdout for o in options), proc.stdout
