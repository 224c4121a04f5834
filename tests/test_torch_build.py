"""PyTorch port, kernel build: the build digest follows every source under
``csrc/``, the generated table header states ``PACKED``, and the shared
pairing core (``csrc/lower_star.cuh``, which also compiles as plain C++)
gives the rows of the JAX package's jnp oracle and of the plain PyTorch
version.  Nothing here needs nvcc or a card; the core tests compile with
the host's C++ compiler and skip without one."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import grid as JG
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF

from repro_torch.core import gradient as GR
from repro_torch.core.gradient import neighbor_orders
from repro_torch.core.grid import Grid, vertex_order
from repro_torch.kernels import build, ref


def _csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_digest_follows_every_source(tmp_path, monkeypatch, edit):
    csrc = _csrc_copy(tmp_path, monkeypatch)
    header = build.tables_header()
    before = {n: build._digest(n, header) for n in build.SOURCES}
    assert before == {n: build._digest(n, header) for n in build.SOURCES}
    if edit == "header":
        p = csrc / "lower_star.cuh"
        p.write_text(p.read_text() + "\n// touched\n")
    elif edit == "source":
        p = csrc / "prepass.cu"
        p.write_text(p.read_text() + "\n")
    else:
        (csrc / "extra.h").write_text("#pragma once\n")
    after = {n: build._digest(n, header) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)


def test_digest_follows_table_header_and_ignores_other_files(
        tmp_path, monkeypatch):
    csrc = _csrc_copy(tmp_path, monkeypatch)
    header = build.tables_header()
    d = build._digest("fused", header)
    assert build._digest("fused", header + "// x\n") != d
    (csrc / "notes.txt").write_text("not a source")
    assert build._digest("fused", header) == d
    assert build._digest("prepass", header) != d


def _xlist(header, name):
    body = re.search(rf"#define {name}\(X\) \\\n(.*?)(?:\n(?!  )|\Z)",
                     header, re.S).group(1)
    return [tuple(int(v) for v in m.split(","))
            for m in re.findall(r"X\(([^)]*)\)", body)]


def test_tables_header_states_packed():
    """Edges name their neighbour slot and offset; triangles their face
    edges; tets their face triangles and other vertices' edges."""
    h = build.tables_header()
    oth = GR.PACKED["others"].astype(int)
    fid = GR.PACKED["fid"].astype(int)
    edges, tris, tets = (_xlist(h, n) for n in
                         ("LS_EDGES", "LS_TRIS", "LS_TETS"))
    assert (len(edges), len(tris), len(tets)) == (14, 36, 24)
    nbr = oth[:14, 0]
    for e, j, dx, dy, dz in edges:
        assert j == nbr[e] == (dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)
    for i, ea, eb in tris:
        assert [ea, eb] == list(fid[14 + i, :2])
        assert sorted(nbr[[ea, eb]]) == sorted(oth[14 + i, :2])
    for i, ta, tb, tc, ea, eb, ec in tets:
        assert [ta, tb, tc] == list(fid[50 + i] - 14)
        assert list(nbr[[ea, eb, ec]]) == list(oth[50 + i])
    assert f"#define LS_R {GR.NROWS}" in h


_HOST_CORE = r"""
#include "lower_star.cuh"
template <typename T>
static void run(const T* nbrs, const T* ov, long long n, int8_t* status,
                int8_t* partner, int8_t* vstat, int32_t* vpart) {
  ls::Tables tb;
  ls::build_tables(tb, 0, 1);
  for (long long v = 0; v < n; ++v) {
    T nb[ls::NE];
#define LS_X(e, j, dx, dy, dz) nb[e] = nbrs[v * 27 + (j)];
    LS_EDGES(LS_X)
#undef LS_X
    uint32_t rk[ls::NE];
    ls::local_ranks<T>(nb, ov[v], rk);
    ls::pair_lower_star(rk, tb, status + v * ls::R, partner + v * ls::R,
                        vstat[v], vpart[v]);
  }
}
extern "C" void core_i32(const int32_t* a, const int32_t* b, long long n,
                         int8_t* s, int8_t* p, int8_t* vs, int32_t* vp) {
  run(a, b, n, s, p, vs, vp);
}
extern "C" void core_i64(const int64_t* a, const int64_t* b, long long n,
                         int8_t* s, int8_t* p, int8_t* vs, int32_t* vp) {
  run(a, b, n, s, p, vs, vp);
}
"""


@pytest.fixture(scope="module")
def host_core(tmp_path_factory):
    """The pairing core of both kernels, compiled for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("core")
    (d / "ls_tables.h").write_text(build.tables_header())
    (d / "core.cpp").write_text(_HOST_CORE)
    so = d / "libcore.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(d), "-I",
                    str(build.CSRC), "-o", str(so), str(d / "core.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for f in (lib.core_i32, lib.core_i64):
        f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + \
            [ctypes.c_void_p] * 4
    return lib


@pytest.mark.parametrize("offset", [0, 3 << 31])
@pytest.mark.parametrize("dims", [(5, 3, 7), (7, 5, 1), (1, 5, 6), (9, 4),
                                  (16,), (12, 11, 10)])
def test_host_core_matches_plain(host_core, dims, offset):
    """The CUDA kernels' pairing core gives the plain version's rows bit
    for bit (tolerance 0), on int32 ranks and on int64 ranks above 2**31,
    for smooth, random and tied fields."""
    g = Grid.of(*dims)
    rng = np.random.default_rng(16)
    for f in (rng.standard_normal(g.nv), np.sin(np.arange(g.nv) * 0.37),
              rng.integers(0, 3, g.nv).astype(np.float64)):
        o = vertex_order(torch.from_numpy(f))
        want = ref.lower_star_gradient_torch(neighbor_orders(g, o), o,
                                             rank_bound=g.nv)
        to = (o + offset).to(torch.int32 if offset == 0 else torch.int64)
        got = _run_core(host_core, neighbor_orders(g, to), to)
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def _run_core(host_core, nb, to):
    """Rows of the host-compiled core for (n, 27) neighbour ranks and
    (n,) vertex ranks, int32 or int64."""
    nb, to = nb.contiguous(), to.contiguous()
    n = to.shape[0]
    got = (torch.empty((n, 74), dtype=torch.int8),
           torch.empty((n, 74), dtype=torch.int8),
           torch.empty(n, dtype=torch.int8), torch.empty(n, dtype=torch.int32))
    fn = host_core.core_i32 if to.dtype == torch.int32 else host_core.core_i64
    fn(nb.data_ptr(), to.data_ptr(), n, *(t.data_ptr() for t in got))
    return got


# asymmetric dims + 1-thin slabs, 2-D and 1-D grids (tests/test_fused.py)
FUSED_DIMS = [(5, 3, 7), (4, 4, 4), (7, 5, 1), (1, 5, 6), (6, 1, 5),
              (2, 2, 2), (9, 4), (16,)]
# (name, rank dtype, offset): an offset of 2**40 puts every rank on the
# oracle's column-key path (no packing past 2**21)
RANK_VARIANTS = [("i32_packed", torch.int32, 0),
                 ("i64_packed", torch.int64, 0),
                 ("i64_columns", torch.int64, 2 ** 40)]


@pytest.mark.parametrize("variant", RANK_VARIANTS, ids=lambda v: v[0])
@pytest.mark.parametrize("dims", FUSED_DIMS)
def test_local_key_pairing_matches_jnp_oracle(host_core, dims, variant):
    """The kernels' pairing core, which pops by the local-rank keys
    (``ref.local_rank_keys`` is their plain form), gives the JAX oracle's
    rows bit for bit (tolerance 0: integer outputs), for int32 and int64
    ranks on the oracle's packed and column key paths."""
    _, dtype, offset = variant
    g, jg = Grid.of(*dims), JG.Grid.of(*dims)
    f = np.random.default_rng(15).standard_normal(g.nv).astype(np.float32)
    order = np.asarray(JG.vertex_order(f))
    to = (torch.from_numpy(order) + offset).to(dtype)
    nb = neighbor_orders(g, to)
    if offset:
        want = JREF.lower_star_gradient_jnp(jnp.asarray(nb.numpy()),
                                            jnp.asarray(to.numpy()),
                                            rank_bound=None)
    else:
        want = JOPS.lower_star_gradient(jg, order, backend="jax")
    for a, b, name in zip(want, _run_core(host_core, nb, to),
                          ("status", "partner", "vstat", "vpart")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{dims} {variant[0]} {name}")
