"""Run one cell of the port's benchmark and print its result.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells; the
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit), and the last lines of standard error repeat the numbers
compared.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, read from a run under ``torch.profiler``.

The run exits with 2, and prints no result, where there is no CUDA
device or fewer than the cell asks for, where the program cannot be
imported, and where the process holds JAX or the JAX package once the
window has closed.  Kernel and compiler caches stay inside the checkout,
at fixed paths: the port builds its kernels into
``src/repro_torch/kernels/build/``, and any torch extension or Triton
cache goes under ``.bench_cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)

    from bench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program is not here: {exc}", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START)
    print("device: " + harness.nvidia_smi_line(), file=sys.stderr,
          flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}", file=sys.stderr)
        return 2
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
