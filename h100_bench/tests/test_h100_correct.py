"""``correct`` at a size a test run holds, on the CPU: a whole run of each
kind of cell past the harness's look for a card, sound, with each fault the
cell can have planted under its timed path, and with its control in the
program's place.  The same runs at the cells' own sizes need the card
(``card`` tests at the end)."""

import json
import subprocess
import sys

import pytest
import torch

from h100_bench import harness as H
from h100_bench.tests import tiny

SEEDS = (1, 2 ** 31 + 5, 98765432109)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(kind, **kw):
    return H.driver(kind).run(tiny.cell(kind, **kw))


@pytest.mark.parametrize("kind", ["batch", "train"])
def test_a_sound_run_is_correct(kind):
    out = run(kind, seed=SEEDS[1])
    assert out.correct, out.compared
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("kind, fault", [("batch", "token"), ("train", "unchanged"),
                                         ("train", "half_batch")])
def test_a_planted_fault_makes_the_run_incorrect(kind, fault):
    out = run(kind, seed=SEEDS[0], fault=fault)
    assert not out.correct, out.compared


def test_a_train_step_left_unchanged_reads_one():
    out = run("train", seed=SEEDS[2], fault="unchanged")
    for k in ("change_gap", "loss_gap", "tail_change_gap"):
        assert out.compared[k][0] == pytest.approx(1.0), k


@pytest.mark.parametrize("seed", SEEDS)
def test_the_train_control_fails(seed):
    out = run("train", seed=seed, control=True)
    assert not out.correct, out.compared


def test_the_control_reads_no_better_than_the_program():
    # at this size random weights leave wide gaps between the best logits, so
    # the lower precision seldom changes a token: the control's failure is
    # shown at the cells' own sizes on the card
    for seed in SEEDS:
        sound = run("batch", seed=seed, rows=16, judge_rows=32)
        ctl = run("batch", seed=seed, control=True, rows=16, judge_rows=32)
        assert ctl.compared["mean_gap"][0] >= sound.compared["mean_gap"][0]


# ---------------------------------------------------------------------------
# On the card, at the cells' own sizes
# ---------------------------------------------------------------------------

def card_run(workload, seed, *extra):
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", workload,
                          "--seed", str(seed), "--seconds", "3", "--trace", "0", *extra],
                         cwd=H.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.splitlines()[-1])


CONTROLLED = [w["name"] for w in H.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CONTROLLED)
def test_on_the_card_sound_runs_pass_and_the_control_fails(card, workload):
    for seed in SEEDS:
        assert card_run(workload, seed)["correct"]
        assert not card_run(workload, seed, "--control", "1")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("workload, fault", [
    ("clipcap-124m.batch512-greedy-f32", "token"),
    ("clipcap-124m.train-b128-bf16", "unchanged"),
    ("clipcap-124m.train-b128-bf16", "half_batch")])
def test_on_the_card_a_planted_fault_fails(card, workload, fault):
    assert not card_run(workload, SEEDS[0], "--fault", fault)["correct"]
