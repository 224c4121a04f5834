"""The control of a cell's check: the plain reference put in the
program's place, computed in the precision below the one the
configuration states (the field rounded to bfloat16 for a float32
configuration), and judged by the same comparison.  It has to come out
as not correct.  The benchmark's runs never run it.

    python bench/control.py --workload <cell> --seeds 1 2 3 [--dims N N N]

prints, per seed, each number compared beside its limit, and a last line
of JSON with every reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device, dims=None) -> dict:
    """The control's numbers on a field of the cell's size made from
    ``seed`` (index 0, blob layout ``seed mod field_layouts``)."""
    from bench import fields, found
    cfg = cell.config
    dims = tuple(dims or cfg["dims"])
    layout = seed % int(cell.traffic["field_layouts"])
    f = fields.make(cfg["field"], dims, seed, 0, layout, device)
    check = found.load("checks", cell.traffic["check"]["reference"])
    kept = check.control(f, dims, cfg, cell.traffic["check"], seed)
    return {k: v for k, (v, _) in check.compare(f, dims, kept).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dims", type=int, nargs=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from bench import harness
    cell = harness.load_cell(args.workload)
    out = {}
    for s in args.seeds:
        t = time.perf_counter()
        out[s] = readings(cell, s, args.device, args.dims)
        print(f"seed {s}: {out[s]} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
