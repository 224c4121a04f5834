"""The general part of a run: find the cell, its configuration and its
traffic by name, run the traffic's driver, read the metrics the cell
reports, decide ``correct`` and print the result.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by name:

- ``BENCHMARK.json`` names the cell's configuration (its ``file``) and
  its traffic, ``bench/traffic/<traffic>.json``;
- the traffic file names its driver, ``bench/drivers/<driver>.py``,
  whose ``run`` makes the requests and returns the run's readings, and
  its check, ``bench/checks/<check.reference>.py``;
- the configuration names its field's formula,
  ``bench/fields/<field.formula>.py``;
- each per-layer metric is read by ``bench/metrics/<name>.py``, whose
  ``read(ctx)`` returns a number, or None where the run holds nothing
  for it to read.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


@dataclass
class Outcome:
    """What a driver returns: the end-to-end readings by metric name, the
    context the per-layer readers read, the requests attempted and
    failed, the numbers compared (name -> (value, limit)) and the
    device's readings."""

    e2e: Dict[str, float]
    ctx: Dict[str, Any]
    attempted: int
    failed: int
    checks: Dict[str, tuple]
    device: Dict[str, Any]
    breakdown: Optional[Dict[str, list]] = None


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the checkout's ``BENCHMARK.json``."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def driver(traffic: Dict[str, Any]):
    return importlib.import_module("bench.drivers." + traffic["driver"])


def metric_reader(name: str):
    """The ``read`` of ``bench/metrics/<name>.py``."""
    from bench import found
    return found.load("metrics", name).read


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is one the run must not hold."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The result line's object; ``checks`` comes last."""
    checked = bool(out.checks)
    ok = checked and out.failed == 0 and all(
        v <= lim for v, lim in out.checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(out.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    line = {"correct": ok, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             config_overrides: Optional[dict] = None) -> dict:
    """Run one cell and return its result line's object.

    ``device`` and ``config_overrides`` (keys of the configuration file
    replaced, such as ``dims``) are for the tests, which drive a run on
    the CPU at a small size."""
    cell = load_cell(name)
    if config_overrides:
        cell.config = {**cell.config, **config_overrides}
    out = driver(cell.traffic).run(cell, seed=seed, seconds=seconds,
                                   trace=trace, device=device,
                                   t_start=t_start)
    return result(cell, out, trace)


def emit(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then
    the result as the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unreadable ({exc!r})"
    return "; ".join(out.stdout.strip().splitlines()) or "nvidia-smi: empty"
