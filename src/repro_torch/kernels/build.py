"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared``) under ``kernels/build/`` (listed in ``.gitignore``), named
by a hash of the sources, the generated table header and the flags, so
an edited source rebuilds and an unchanged one loads at once.  The table
header ``ls_tables.h`` is written from ``core.gradient.PACKED``.
:func:`build_all` starts one nvcc per source, all at once.

Nothing here runs when the module is imported; nothing here falls back:
a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import numpy as np

from repro_torch.core import gradient as GR
from repro_torch.core import grid as G

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused", "prepass")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time (0 when loaded from disk), "log": ptxas}
BUILD_INFO: Dict[str, dict] = {}


def tables_header() -> str:
    """ls_tables.h: the packed star tables as __constant__ arrays."""
    def rows(a: np.ndarray) -> str:
        return ",\n".join("  {" + ", ".join(str(int(x)) for x in r) + "}"
                          for r in a)
    return (
        "// Generated from repro_torch.core.gradient.PACKED; do not edit.\n"
        "#pragma once\n#include <cstdint>\n"
        f"#define LS_R {GR.NROWS}\n#define LS_EDGE_ROWS {G.NSTAR[1]}\n"
        f"__constant__ int8_t LS_OTH[{GR.NROWS}][3] = {{\n"
        f"{rows(GR.PACKED['others'])}\n}};\n"
        f"__constant__ int8_t LS_FID[{GR.NROWS}][3] = {{\n"
        f"{rows(GR.PACKED['fid'])}\n}};\n")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _digest(name: str, header: str) -> str:
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", CSRC / "lower_star.cuh"):
        h.update(p.read_bytes())
    h.update(header.encode())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def _start(name: str):
    """Start nvcc for one source; returns (so path, Popen or None, t0)."""
    header = tables_header()
    out_dir = BUILD_DIR / _digest(name, header)
    so = out_dir / f"lib{name}.so"
    if so.exists():
        return so, None, time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    hdr = out_dir / "ls_tables.h"
    if not hdr.exists():
        tmp = out_dir / f"ls_tables.h.{os.getpid()}"
        tmp.write_text(header)
        os.replace(tmp, hdr)
    tmp_so = out_dir / f"lib{name}.so.{os.getpid()}"
    cmd = [_nvcc(), *FLAGS, "-I", str(out_dir), "-I", str(CSRC),
           "-o", str(tmp_so), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, (proc, tmp_so), time.perf_counter()


def _finish(name: str, so: Path, pending, t0: float) -> None:
    if pending is not None:
        proc, tmp_so = pending
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp_so, so)
        (so.parent / f"{name}.log").write_text(log)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
    else:
        logf = so.parent / f"{name}.log"
        BUILD_INFO[name] = {"seconds": 0.0,
                            "log": logf.read_text() if logf.exists() else ""}
    _LIBS[name] = ctypes.CDLL(str(so))


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Build (or load) every named kernel library, one nvcc per source,
    all started together.  Returns ``BUILD_INFO``."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        started = [(n, *_start(n)) for n in todo]
        for n, so, pending, t0 in started:
            _finish(n, so, pending, t0)
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib
