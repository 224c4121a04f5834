"""The ring cell driven on the CPU: four gloo ranks at a small grid, its
check against the control and against faults planted underneath it."""

import json
import os
import subprocess
import sys

import pytest

from bench import control, found, harness

CELL = "isabel-512-4card.ring4"
SMALL = {"dims": [12, 10, 16]}
CHECKS = set(found.load("checks", "ring").LIMITS)


def _run(seed, seconds=1.0, trace=False, **over):
    return harness.run_cell(CELL, seed, seconds, trace, device="cpu",
                            config_overrides={**SMALL, **over})


def test_sound_run_is_correct():
    line = _run(2**31 + 17)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == CHECKS
    assert line["device"]["count"] == 4 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"ring_front_s", "setup_s"}


def test_traced_run_reads_the_steps():
    line = _run(5, trace=True)
    assert line["correct"] is True, line["checks"]
    assert {"sort_s.ring", "halo_gradient_s.ring",
            "resolve_s.ring"} <= set(line["metrics"])


def test_control_is_not_correct():
    cell = harness.load_cell(CELL)
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, "cpu", dims=SMALL["dims"])
        assert got["rank_mismatch"] > 100, got


@pytest.mark.parametrize("fault,number", [
    ("no_exchange", "critical_count_mismatch"),
    ("altered_answer", "vertex_row_mismatch"),
    ("one_rank_differs", "rank_digest_mismatch")])
def test_fault_is_caught(fault, number):
    """In a process of its own: the fault stays in the ranks it breaks."""
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from bench import harness\n"
        "line = harness.run_cell(sys.argv[3], 11, 1.0, False, device='cpu',"
        " config_overrides=json.loads(sys.argv[4]))\n"
        "print(json.dumps(line))\n")
    over = {**SMALL, "rank_hook": f"bench.tests.ring_faults:{fault}"}
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT,
                          os.path.join(harness.ROOT, "src"), CELL,
                          json.dumps(over)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is False
    assert line["checks"][number]["value"] > 0, line["checks"]
