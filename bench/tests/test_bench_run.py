"""A run driven on the CPU at a small size: what it imports, that it
refuses to run without a card, and that its check catches the control
and a timed path broken underneath it."""

import ast
import json
import os
import random
import shutil
import subprocess
import sys

import pytest
import torch

from bench import control, found, harness

ROOT = harness.ROOT
CELL = "isabel-336.d0"
SMALL = {"dims": [16, 16, 12]}
# a seed whose checked request is the fourth: the stale fault needs one
SEED = next(s for s in range(100) if random.Random(s).randrange(4) == 3)


def _top(name):
    return name.split(".")[0]


def test_sources_import_no_jax_and_no_reference_package():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                assert not {_top(n) for n in names} & set(harness.FORBIDDEN), \
                    (fn, names)


def test_a_run_loads_no_jax_and_no_reference_package():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from bench import harness\n"
            "line = harness.run_cell(sys.argv[3], 1, 0.1, True, device='cpu',"
            " config_overrides={'dims': [8, 8, 8]})\n"
            "assert line['correct'], line\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT,
                          os.path.join(ROOT, "src"), CELL],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_no_card_no_result(tmp_path):
    """Without a CUDA device, and in a directory that holds only the
    benchmark, the run exits with another code than 0 and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    only = tmp_path / "only"
    shutil.copytree(os.path.join(ROOT, "bench"), only / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), only)
    for cwd in (ROOT, str(only)):
        out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                              CELL, "--seed", "1", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert "correct" not in out.stdout


def test_control_is_not_correct():
    cell = harness.load_cell(CELL)
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, "cpu", dims=(24, 24, 24))
        assert any(v > 0 for v in got.values()), got
        assert got["order_mismatch"] > 1000


def _run(seconds=3.0):
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            config_overrides=SMALL)


def test_sound_run_is_correct():
    line = _run()
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4
    assert set(line["checks"]) == set(found.load("checks", "d0").LIMITS)


def test_altered_answer_is_caught(monkeypatch):
    """A D0 pair's saddle swapped with another's where D0 produces it."""
    from repro_torch.pipeline import stages
    orig = stages.D0Stage.run

    def altered(self, state, cfg, rep):
        orig(self, state, cfg, rep)
        p = state.pairs[0].clone()
        p[0, 1], p[1, 1] = state.pairs[0][1, 1], state.pairs[0][0, 1]
        state.pairs[0] = p
    monkeypatch.setattr(stages.D0Stage, "run", altered)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["d0_pair_mismatch"]["value"] == 4


def test_stale_answer_is_caught(monkeypatch):
    """Every request answered with the first result the pipeline made."""
    from repro_torch.pipeline import api
    orig = api.PersistencePipeline.run
    first = []

    def stale(self, request, grid=None, **kw):
        if not first:
            first.append(orig(self, request, grid, **kw))
        return first[0]
    monkeypatch.setattr(api.PersistencePipeline, "run", stale)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["order_mismatch"]["value"] > 0


def test_order_off_by_a_swap_is_caught(monkeypatch):
    """Two vertices' ranks swapped where the order stage produces them."""
    from repro_torch.pipeline import stages
    orig = stages.OrderStage.run

    def altered(self, state, cfg, rep):
        orig(self, state, cfg, rep)
        o = state.order.clone()
        o[0], o[1] = state.order[1], state.order[0]
        state.order = o
    monkeypatch.setattr(stages.OrderStage, "run", altered)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["order_mismatch"]["value"] == 2


@pytest.mark.cuda
def test_cell_on_the_card_at_a_small_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = harness.run_cell(CELL, 11, 2.0, True,
                            config_overrides={"dims": [64, 64, 64]})
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert json.dumps(line)
