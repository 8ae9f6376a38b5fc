"""The harness finds everything by name, the import guard, and the run's
refusals."""

import json
import os
import subprocess
import sys

import pytest

from h100_bench import guard
from h100_bench import harness as H
from h100_bench.run import cell_metrics

BENCH = H.benchmark()


def test_every_cell_finds_its_files_and_driver():
    for w in BENCH["workloads"]:
        cell = H.load_cell(w["name"], 1, 1.0, False, "cpu")
        assert cell.config["name"] == w["config"]
        assert cell.limits, w["name"]
        assert callable(H.driver(cell.traffic["kind"]).run)
    for c in BENCH["configs"]:
        cfg = H.load_json(H.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        assert {"gpt2", "vision", "mapping", "eos_token_id"} <= set(cfg)


def test_every_per_layer_metric_has_a_reader_and_a_cell():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"setup_s", "captions_per_s", "train_captions_per_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert (H.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:  # each cell it lists reports the metric it moves
            assert m["moves"] in {x["name"] for x in cell_metrics(BENCH, w, "end_to_end")}


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) == 2, (w["name"], e2e)
        assert cell_metrics(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("modules, found", [
    ({"jax": object(), "jax.numpy": object()}, ["jax"]),
    ({"gpt2_image_captioning_tpu.models": object()}, ["gpt2_image_captioning_tpu"]),
    ({"gpt2_image_captioning_tpu_torch": object(), "flaxx": object()}, []),
    ({"jaxlib": None}, []),  # a blocked import is not a loaded module
])
def test_guard_compares_whole_top_level_names(modules, found):
    assert guard.loaded_banned(modules) == found


def test_reference_imports_nothing_of_the_port_or_jax(tmp_path):
    assert guard.reference_imports() == {}
    bad = tmp_path / "reference"
    bad.mkdir()
    (bad / "leak.py").write_text("import torch\nfrom gpt2_image_captioning_tpu_torch.ops import nn\n")
    assert guard.reference_imports(bad) == {"reference/leak.py": [guard.PORT]}


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.');"
            "import h100_bench.harness, h100_bench.drivers.batch, h100_bench.drivers.train,"
            " gpt2_image_captioning_tpu_torch.serving,"
            " gpt2_image_captioning_tpu_torch.train.loop;"
            "from h100_bench import guard; print(guard.loaded_banned())")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 7),
                          "--seconds", "1", "--trace", "0"], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "refused" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and len(c["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
