"""``BENCHMARK.json`` against the rules a benchmark keeps, and the
harness finding a configuration, a mix and a metric by name alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_four_chip_cells_are_few():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


def test_every_file_named_exists():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert set(c["reduced"]) <= set(json.load(open(os.path.join(
            ROOT, c["file"]))))
    for w in BENCH["workloads"]:
        mix = json.load(open(os.path.join(ROOT, "bench", "traffic",
                                          w["traffic"] + ".json")))
        assert os.path.isfile(os.path.join(ROOT, "bench", "drivers",
                                           mix["driver"] + ".py"))
        assert os.path.isfile(os.path.join(ROOT, "bench", "checks",
                                           mix["check"]["reference"]
                                           + ".py"))
        conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
        formula = json.load(open(os.path.join(ROOT, conf["file"])))[
            "field"]["formula"]
        assert os.path.isfile(os.path.join(ROOT, "bench", "fields",
                                           formula + ".py"))
    for m in BENCH["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "bench", "metrics",
                                           m["name"] + ".py"))


def _e2e_of(cell):
    return {m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_moves_is_reported_where_the_metric_is():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in _e2e_of(c)
    for c in cells:
        assert "setup_s" in _e2e_of(c) and len(_e2e_of(c)) >= 2
        assert any(c in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_added_files_are_found_by_name(tmp_path):
    """A configuration with a field formula of its own, a mix with a check
    of its own, and a per-layer metric, each added as files with entries
    in a copy of ``BENCHMARK.json``, are found and run with no file that
    was there edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "bench"), root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*.py")}
    bench = json.loads(json.dumps(BENCH))
    d0_cfg = next(c for c in BENCH["configs"] if c["name"] == "isabel-336")
    cfg = json.load(open(os.path.join(ROOT, d0_cfg["file"])))
    cfg["dims"] = [8, 8, 8]
    cfg["field"] = {"formula": "ramp", "tilt": 0.5}
    (root / "bench" / "configs" / "tiny-8.json").write_text(json.dumps(cfg))
    (root / "bench" / "fields" / "ramp.py").write_text(
        "import torch\n"
        "from bench.fields import request_seed\n\n\n"
        "def make(dims, seed, index, layout, device, tilt=1.0):\n"
        "    g = torch.Generator(device=device)\n"
        "    g.manual_seed(request_seed(seed, index))\n"
        "    n = dims[0] * dims[1] * dims[2]\n"
        "    ramp = torch.arange(n, device=device, dtype=torch.float32)\n"
        "    return tilt * ramp / n + torch.rand(n, generator=g,\n"
        "                                        device=device)\n")
    (root / "bench" / "checks" / "order_only.py").write_text(
        "from bench import found\n"
        "LIMITS = {'order_mismatch': 0}\n"
        "_d0 = found.load('checks', 'd0')\n"
        "program = _d0.program\n\n\n"
        "def compare(field, dims, kept):\n"
        "    got = _d0.compare(field, dims, kept)\n"
        "    return {k: got[k] for k in LIMITS}\n\n\n"
        "def control(field, dims, cfg, check_cfg, seed):\n"
        "    return _d0.control(field, dims, cfg, check_cfg, seed)\n")
    mix = json.load(open(os.path.join(ROOT, "bench", "traffic", "d0.json")))
    mix["name"] = "d0-again"
    mix["check"]["reference"] = "order_only"
    (root / "bench" / "traffic" / "d0-again.json").write_text(
        json.dumps(mix))
    (root / "bench" / "metrics" / "requests_n.py").write_text(
        "def read(ctx):\n    return ctx.get('n_requests')\n")
    bench["configs"].append(dict(d0_cfg, name="tiny-8",
                                 file="bench/configs/tiny-8.json"))
    bench["workloads"].append({"name": "tiny-8.d0-again", "config": "tiny-8",
                               "traffic": "d0-again", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "isabel-336.d0" in m.get("workloads", []):
            m["workloads"].append("tiny-8.d0-again")
    bench["per_layer"].append({"name": "requests_n", "unit": "requests",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "diagram_s",
                               "workloads": ["tiny-8.d0-again"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from bench import control, harness\n"
        "line = harness.run_cell('tiny-8.d0-again', 3, 0.2, True,"
        " device='cpu')\n"
        "cell = harness.load_cell('tiny-8.d0-again')\n"
        "line['control'] = control.readings(cell, 4, 'cpu')\n"
        "print(json.dumps(line))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root),
                          os.path.join(ROOT, "src")], capture_output=True,
                         text=True, timeout=300, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["checks"]) == {"order_mismatch"}
    assert line["control"]["order_mismatch"] > 0
    assert line["metrics"]["requests_n"]["value"] >= 1
    assert "d0_s" in line["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
