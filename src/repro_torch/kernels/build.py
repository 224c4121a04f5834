"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared``) under ``kernels/build/`` (listed in ``.gitignore``), named
by a hash of every source under ``csrc/`` (``*.cu``, ``*.cuh``, ``*.h``),
the generated table header and the flags, so an edited or added source
rebuilds and an unchanged tree loads at once.  The table header
``ls_tables.h`` is written from ``core.gradient.PACKED``.
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
    """ls_tables.h: the packed star as X-macro lists of compile-time
    constants, so every loop over the 74 rows unrolls with known indices.

    Edge row e joins the vertex to one neighbour; a triangle's faces in
    the star are the edges to its two other vertices, and a tet's are
    the triangles on its three.  So the lists name triangles by their
    edges and tets by their triangles, in ``PACKED["fid"]`` order."""
    oth = GR.PACKED["others"].astype(int)
    fid = GR.PACKED["fid"].astype(int)
    ne, nt, nq = (int(G.NSTAR[k]) for k in (1, 2, 3))
    t0, q0 = ne, ne + nt
    edge_of = {int(oth[e, 0]): e for e in range(ne)}

    def slot(j):                    # neighbour slot -> (dx, dy, dz)
        return j % 3 - 1, j // 3 % 3 - 1, j // 9 - 1

    edges = " \\\n  ".join(
        "X({}, {}, {}, {}, {})".format(e, int(oth[e, 0]), *slot(int(oth[e, 0])))
        for e in range(ne))
    tris = " \\\n  ".join(
        f"X({i}, {fid[t0 + i, 0]}, {fid[t0 + i, 1]})" for i in range(nt))
    tets = " \\\n  ".join(
        "X({}, {}, {}, {}, {}, {}, {})".format(
            i, *(fid[q0 + i] - t0), *(edge_of[int(j)] for j in oth[q0 + i]))
        for i in range(nq))
    return (
        "// Generated from repro_torch.core.gradient.PACKED; do not edit.\n"
        "#pragma once\n"
        f"#define LS_R {GR.NROWS}\n#define LS_NE {ne}\n"
        f"#define LS_NT {nt}\n#define LS_NQ {nq}\n"
        "// X(e, j, dx, dy, dz): edge row e joins the vertex to neighbour\n"
        "// slot j = (dx+1) + 3(dy+1) + 9(dz+1)\n"
        f"#define LS_EDGES(X) \\\n  {edges}\n"
        "// X(i, ea, eb): triangle row LS_NE + i, faces edges ea, eb\n"
        f"#define LS_TRIS(X) \\\n  {tris}\n"
        "// X(i, ta, tb, tc, ea, eb, ec): tet row LS_NE + LS_NT + i, faces\n"
        "// triangles ta, tb, tc; other vertices those of edges ea, eb, ec\n"
        f"#define LS_TETS(X) \\\n  {tets}\n")


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
    """Hash of every source under ``CSRC`` (names and bytes), the table
    header and the flags: any edited or added source names a new build."""
    h = hashlib.sha256(name.encode())
    for p in sorted(q for pat in ("*.cu", "*.cuh", "*.h")
                    for q in CSRC.glob(pat)):
        h.update(p.name.encode())
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
