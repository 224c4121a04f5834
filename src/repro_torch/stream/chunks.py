"""Chunked field sources + z-slab block decomposition for out-of-core runs.

The paper computes persistence for fields far larger than any single
memory (6G vertices, Sec. VI): both DIPHA and DDMS rest on a block
decomposition with ghost layers.  This module is the data half of that
story (PyTorch counterpart of ``repro.stream.chunks``; pure numpy but for
the torch twins of the key packing, which run on the card):

- :class:`FieldSource` — the protocol the streaming engine reads from: a
  shaped scalar field that can serve any contiguous **z-slab** of planes
  on demand, without ever materializing the whole array.  Shipped
  sources: an in-memory array (reference/testing), an ``np.memmap``
  backed file (fields on disk), and a pure-function source that
  *generates* a chunk on demand (synthetic benchmark fields at any
  resolution — see ``repro_torch.fields.generators.make_field_chunk``).
- :func:`plan_chunks` — the z-slab decomposition with 1-vertex ghost
  layers: every chunk owns ``[zlo, zhi)`` planes and reads one extra
  plane on each side (clipped at the global boundary), which is exactly
  the halo the fused lower-star kernel's halo entry expects.
- :func:`pack_value_keys` — rank-free packed ``(value, vid)`` keys: a
  monotone injection of the global vertex order into non-negative int64
  words.  The kernels only ever *compare* orders, so these keys replace
  dense ranks bit-identically — and unlike ranks they are computable
  per chunk with zero global communication (no global argsort, the
  out-of-core analogue of the distributed engines' rank-free keys).
  :func:`pack_value_keys_torch` / :func:`unpack_value_keys_torch` are
  the same maps on tensors, so a slab is packed on the card.

Key layout: ``((sortable32(f) + 2^31) << 31) | vid`` — 32 bits of
sign-magnitude-folded float32 above 31 bits of vertex id.  All keys are
``>= 0`` so the kernels' ``-1`` outside-the-grid sentinel stays below
every real key.  Constraints (checked): float32 values, ``nv < 2^31``
(larger grids need a two-word key; the fold maps -0.0 and +0.0 to the
same word, so ties break by vid exactly like the stable argsort in
``vertex_order``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

import torch

from repro_torch.core.grid import Grid

MAX_STREAM_NV = 2 ** 31  # vid must fit 31 bits of the packed key


class CacheKeyError(ValueError):
    """A field source cannot be given a stable content fingerprint.

    Raised by :meth:`FieldSource.fingerprint` implementations that have
    no way to identify their content without reading all of it (e.g. a
    :class:`FunctionSource` wrapping an arbitrary closure).  The diagram
    cache (``cache/``, ROADMAP.md Queue 1 item 8) treats this as an
    explicit opt-out: such
    requests compute normally and are never cached."""


# --------------------------------------------------------------------------
# rank-free packed keys
# --------------------------------------------------------------------------

def sortable32(f: np.ndarray) -> np.ndarray:
    """Monotone float32 -> int64 map (IEEE754 sign-magnitude fold).

    Order-preserving, and ``-0.0`` folds onto ``+0.0`` so float ties
    (including signed zeros) are broken purely by vid downstream."""
    f = np.ascontiguousarray(f, dtype=np.float32)
    fi = f.view(np.int32).astype(np.int64)
    return np.where(fi < 0, -(fi + 2 ** 31), fi)


def pack_value_keys(values: np.ndarray, vids: np.ndarray) -> np.ndarray:
    """Non-negative int64 keys ordered exactly like (value, vid).

    ``values`` float32, ``vids`` int64 global vertex ids < 2^31.  The
    result is order-isomorphic to ``vertex_order`` ranks: sorting keys
    is sorting (value, vid) lexicographically."""
    vids = np.asarray(vids, dtype=np.int64)
    return ((sortable32(values).reshape(-1) + 2 ** 31) << np.int64(31)) | vids


def unpack_value_keys(keys: np.ndarray) -> np.ndarray:
    """Recover the float32 field values packed into (value, vid) keys.

    Exact inverse of the ``sortable32`` fold in :func:`pack_value_keys`,
    except ``-0.0`` (folded onto ``+0.0``) comes back as ``+0.0``.  This
    is how the streamed pipeline serves *value-space* diagram points
    without ever materializing the field."""
    s = (np.asarray(keys, dtype=np.int64) >> np.int64(31)) - 2 ** 31
    fi = np.where(s >= 0, s, -s - 2 ** 31)
    return fi.astype(np.int32).view(np.float32)


def pack_value_keys_torch(values: torch.Tensor, vid0: int) -> torch.Tensor:
    """:func:`pack_value_keys` on a tensor: keys of float32 ``values`` at
    the consecutive vids ``vid0, vid0 + 1, ...``, on ``values``' device."""
    if values.dtype != torch.float32:
        raise TypeError(f"packed keys need float32 values, got {values.dtype}")
    fi = values.contiguous().reshape(-1).view(torch.int32).long()
    s = torch.where(fi < 0, -(fi + 2 ** 31), fi)
    vids = torch.arange(vid0, vid0 + fi.numel(), dtype=torch.int64,
                        device=values.device)
    return ((s + 2 ** 31) << 31) | vids


def unpack_value_keys_torch(keys: torch.Tensor) -> torch.Tensor:
    """:func:`unpack_value_keys` on a tensor: the float32 values of
    (value, vid) keys (-0.0 comes back as +0.0)."""
    s = (keys.long() >> 31) - 2 ** 31
    fi = torch.where(s >= 0, s, -s - 2 ** 31)
    return fi.to(torch.int32).view(torch.float32)


# --------------------------------------------------------------------------
# FieldSource protocol + implementations
# --------------------------------------------------------------------------

@runtime_checkable
class FieldSource(Protocol):
    """A scalar field served z-slab by z-slab.

    ``dims`` is the grid vertex shape ``(nx, ny, nz)`` (vid = x + nx*(y +
    ny*z), i.e. numpy plane layout ``[z, y, x]``).  ``read_slab(zlo,
    zhi)`` returns a fresh float32 array of shape ``(zhi - zlo, ny, nx)``
    — the only access path the streaming engine uses, so any storage
    (array, file, object store, generator) plugs in here.

    ``fingerprint()`` returns a stable content-identity string — equal
    fingerprints must imply bit-identical ``read_slab`` output — or
    raises :class:`CacheKeyError` for sources that cannot identify their
    content cheaply.  It is independently usable (provenance stamps,
    dedup) and is what the diagram cache (``cache/``) keys on.
    Duck-typed sources without it still stream fine (``as_source`` only
    requires ``dims``/``read_slab``); they are simply uncacheable."""

    @property
    def dims(self) -> Tuple[int, int, int]: ...

    def read_slab(self, zlo: int, zhi: int) -> np.ndarray: ...

    def fingerprint(self) -> str: ...


def _check_dims(dims) -> Tuple[int, int, int]:
    g = Grid.of(*dims)
    if g.nv >= MAX_STREAM_NV:
        raise ValueError(
            f"streamed grids need nv < 2^31 for packed (value, vid) keys; "
            f"got nv={g.nv} for dims {g.dims}")
    return g.dims


def _check_slab(dims, zlo: int, zhi: int) -> None:
    nz = dims[2]
    if not (0 <= zlo < zhi <= nz):
        raise IndexError(f"slab [{zlo}, {zhi}) out of range for nz={nz}")


class ArraySource:
    """In-memory field as a :class:`FieldSource` (reference / testing).

    Accepts a flat (nv,) field with explicit ``dims`` or a (nz, ny, nx)
    volume.  float32 only — the packed keys are exact for float32."""

    def __init__(self, f: np.ndarray, dims: Optional[Tuple[int, ...]] = None):
        f = np.asarray(f)
        if dims is None:
            if f.ndim != 3:
                raise ValueError(
                    "ArraySource needs dims= for flat fields; pass a "
                    "(nz, ny, nx) volume to infer them")
            dims = f.shape[::-1]
        self._dims = _check_dims(dims)
        if f.dtype != np.float32:
            raise TypeError(
                f"stream sources are float32-only (packed keys are exact "
                f"for float32); got {f.dtype}")
        nx, ny, nz = self._dims
        self._f3 = f.reshape(nz, ny, nx)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self._dims

    def read_slab(self, zlo: int, zhi: int) -> np.ndarray:
        _check_slab(self._dims, zlo, zhi)
        return np.array(self._f3[zlo:zhi], dtype=np.float32)

    def fingerprint(self) -> str:
        """Content digest of the (float32) array bytes + dims."""
        import hashlib
        h = hashlib.sha256(np.ascontiguousarray(self._f3).tobytes())
        return f"array:{self._dims[0]}x{self._dims[1]}x{self._dims[2]}:" \
               f"{h.hexdigest()}"


class MemmapSource:
    """A raw float32 field file read through ``np.memmap``.

    The file holds the field in vid order (x fastest, z slowest) at
    ``offset`` bytes; only the planes of each requested slab are paged
    in, and ``read_slab`` copies them into a fresh array so no memmap
    pages stay pinned by downstream code."""

    def __init__(self, path, dims, *, offset: int = 0):
        self._dims = _check_dims(dims)
        self.path = path
        self.offset = int(offset)
        self._mm: Optional[np.memmap] = None

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self._dims

    def _map(self) -> np.memmap:
        if self._mm is None:
            nx, ny, nz = self._dims
            self._mm = np.memmap(self.path, dtype=np.float32, mode="r",
                                 offset=self.offset, shape=(nz, ny, nx))
        return self._mm

    def read_slab(self, zlo: int, zhi: int) -> np.ndarray:
        _check_slab(self._dims, zlo, zhi)
        return np.array(self._map()[zlo:zhi], dtype=np.float32)

    def fingerprint(self) -> str:
        """Identity of the backing file: path + size + mtime (+ offset).

        Cheap (one ``stat``, no data read); a rewritten file changes
        size or mtime, invalidating stale cache entries.  Raises
        :class:`CacheKeyError` when the file cannot be stat'ed."""
        import os
        try:
            st = os.stat(self.path)
        except OSError as e:
            raise CacheKeyError(
                f"cannot stat {self.path!r} for a memmap fingerprint: "
                f"{e}") from e
        nx, ny, nz = self._dims
        return (f"memmap:{os.fspath(self.path)}:{st.st_size}:"
                f"{st.st_mtime_ns}:{self.offset}:{nx}x{ny}x{nz}")

    @staticmethod
    def write(path, f: np.ndarray, dims=None) -> "MemmapSource":
        """Dump a field to a raw float32 file and return a source on it."""
        src = ArraySource(np.asarray(f, dtype=np.float32), dims)
        nx, ny, nz = src.dims
        np.asarray(src.read_slab(0, nz)).tofile(path)
        return MemmapSource(path, src.dims)


class FunctionSource:
    """Pure-function source: ``fn(zlo, zhi) -> (zhi-zlo, ny, nx)`` float32.

    The chunk is *generated* on demand — the field never exists anywhere.
    ``FunctionSource.synthetic(name, dims, seed)`` wraps the
    chunk-seekable benchmark generators (``repro_torch.fields.generators
    .make_field_chunk``), which reproduce ``make_field`` slices exactly."""

    def __init__(self, fn: Callable[[int, int], np.ndarray], dims, *,
                 name: Optional[str] = None):
        """``name`` is an optional *content identity* for the function:
        callers who can promise that equal names generate bit-identical
        fields (e.g. a registry of deterministic generators) pass one to
        make the source fingerprintable; anonymous closures stay
        unfingerprintable (``fingerprint()`` raises
        :class:`CacheKeyError`)."""
        self._dims = _check_dims(dims)
        self._fn = fn
        self._name = name

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self._dims

    def read_slab(self, zlo: int, zhi: int) -> np.ndarray:
        _check_slab(self._dims, zlo, zhi)
        nx, ny, _ = self._dims
        out = np.asarray(self._fn(zlo, zhi), dtype=np.float32)
        want = (zhi - zlo, ny, nx)
        if out.shape != want:
            raise ValueError(
                f"chunk function returned shape {out.shape}, want {want}")
        return out

    def fingerprint(self) -> str:
        """Generator identity (name + dims + construction) for named
        sources; :class:`CacheKeyError` for anonymous closures — an
        arbitrary function's content cannot be identified without
        evaluating the whole field."""
        if self._name is None:
            raise CacheKeyError(
                "FunctionSource wraps an anonymous function; pass "
                "name= at construction (equal names must generate "
                "bit-identical fields) or use FunctionSource.synthetic")
        nx, ny, nz = self._dims
        return f"fn:{self._name}:{nx}x{ny}x{nz}"

    @staticmethod
    def synthetic(name: str, dims, seed: int = 0) -> "FunctionSource":
        from repro_torch.fields.generators import make_field_chunk
        g = Grid.of(*dims)
        return FunctionSource(
            lambda zlo, zhi: make_field_chunk(name, g.dims, seed, zlo, zhi),
            g.dims, name=f"synthetic:{name}:seed{seed}")


class DecimatedSource:
    """Stride-decimated view of another :class:`FieldSource`.

    The level adapter of the progressive hierarchy (``approx/``, ROADMAP.md
    Queue 1 item 7):
    coarse plane ``cz`` is fine plane ``cz * stride`` subsampled with
    the same stride in x and y, so a power-of-two multiresolution level
    of an out-of-core field streams through the unchanged chunk
    scheduler while reading only the fine planes it keeps (one fine
    plane per coarse plane — never the skipped ones)."""

    def __init__(self, source: FieldSource, stride: int):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self._src = as_source(source)
        self._stride = int(stride)
        self._dims = _check_dims(
            tuple((d + stride - 1) // stride for d in self._src.dims))

    @property
    def dims(self) -> Tuple[int, int, int]:
        return self._dims

    @property
    def stride(self) -> int:
        return self._stride

    def read_slab(self, zlo: int, zhi: int) -> np.ndarray:
        _check_slab(self._dims, zlo, zhi)
        s = self._stride
        planes = [self._src.read_slab(cz * s, cz * s + 1)[0, ::s, ::s]
                  for cz in range(zlo, zhi)]
        return np.ascontiguousarray(np.stack(planes), dtype=np.float32)

    def fingerprint(self) -> str:
        """Delegates to the base source: a decimated view is identified
        by (stride, base content).  Propagates the base's
        :class:`CacheKeyError` unchanged."""
        base = getattr(self._src, "fingerprint", None)
        if base is None:
            raise CacheKeyError(
                f"base source {type(self._src).__name__} has no "
                f"fingerprint()")
        return f"decimated:{self._stride}:{base()}"


def as_source(f, dims=None) -> FieldSource:
    """Coerce ndarray inputs to an :class:`ArraySource`; pass sources through."""
    if isinstance(f, (ArraySource, MemmapSource, FunctionSource,
                      DecimatedSource)):
        return f
    if isinstance(f, np.ndarray):
        return ArraySource(f, dims)
    # structural: any read_slab/dims object is a source (fingerprint()
    # is optional — duck-typed sources without it stream fine, they are
    # just not cacheable)
    if hasattr(f, "read_slab") and hasattr(f, "dims"):
        return f
    raise TypeError(
        f"expected a FieldSource or ndarray, got {type(f).__name__}")


# --------------------------------------------------------------------------
# z-slab decomposition with ghost layers
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Chunk:
    """One z-slab: owned planes [zlo, zhi), loaded planes [glo, ghi).

    The loaded range extends one ghost plane past each owned boundary
    (clipped at the grid), giving the lower-star kernel the complete
    27-neighborhood of every owned vertex.  In a *sharded* plan
    (``plan_chunks(window=...)``), the ghost plane just past a shard
    boundary is owned by the neighbor shard and is **not** part of the
    loaded range: ``halo_below`` / ``halo_above`` mark that the plane at
    ``zlo - 1`` / ``zhi`` arrives through the halo exchange instead of a
    source read."""

    index: int
    zlo: int
    zhi: int
    glo: int
    ghi: int
    halo_below: bool = False
    halo_above: bool = False

    @property
    def nz(self) -> int:
        return self.zhi - self.zlo

    def vid0(self, dims) -> int:
        """Global vid of the first owned vertex."""
        return self.zlo * dims[0] * dims[1]

    def load_bytes(self, dims) -> int:
        """float32 bytes of the loaded (ghost-extended) slab."""
        return (self.ghi - self.glo) * dims[0] * dims[1] * 4


def plan_chunks(dims, *, chunk_z: Optional[int] = None,
                chunk_budget: Optional[int] = None,
                window: Optional[Tuple[int, int]] = None,
                halo_below: bool = False,
                halo_above: bool = False) -> List[Chunk]:
    """Decompose the grid (or one shard's z-``window`` of it) into
    z-slabs of ``chunk_z`` owned planes.

    ``chunk_budget`` (bytes of loaded field data per chunk, ghosts
    included) is the alternative knob: the largest ``chunk_z`` whose
    ghost-extended slab fits the budget (always >= 1 plane).  Exactly one
    of the two must be given.

    ``window=(z0, z1)`` restricts the owned planes to a shard's slab:
    chunks never *load* planes outside the window — a ghost plane past a
    window edge flagged ``halo_below`` / ``halo_above`` belongs to the
    neighbor shard and reaches the kernel through the halo exchange
    (``repro_torch.stream.sharded``), not through ``read_slab``."""
    dims = Grid.of(*dims).dims
    nx, ny, nz = dims
    z0, z1 = (0, nz) if window is None else (int(window[0]), int(window[1]))
    if not (0 <= z0 < z1 <= nz):
        raise ValueError(f"window [{z0}, {z1}) out of range for nz={nz}")
    plane_bytes = nx * ny * 4
    if (chunk_z is None) == (chunk_budget is None):
        raise ValueError("pass exactly one of chunk_z= / chunk_budget=")
    if chunk_z is None:
        chunk_z = max(1, int(chunk_budget) // plane_bytes - 2)
    chunk_z = max(1, min(int(chunk_z), z1 - z0))
    out = []
    for i, zlo in enumerate(range(z0, z1, chunk_z)):
        zhi = min(zlo + chunk_z, z1)
        h_lo = halo_below and zlo == z0
        h_hi = halo_above and zhi == z1
        out.append(Chunk(
            i, zlo, zhi,
            glo=zlo if h_lo else max(0, zlo - 1),
            ghi=zhi if h_hi else min(nz, zhi + 1),
            halo_below=h_lo, halo_above=h_hi))
    return out


def plan_shards(nz: int, n_shards: int) -> List[Tuple[int, int]]:
    """Near-even contiguous z-slab split ``[(z0, z1), ...]`` over shards.

    Clamped to at most one shard per plane (``n_shards > nz`` degrades
    gracefully instead of emitting empty slabs); the first ``nz %
    n_shards`` shards own one extra plane."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n_shards = min(int(n_shards), int(nz))
    base, extra = divmod(int(nz), n_shards)
    out, z0 = [], 0
    for s in range(n_shards):
        z1 = z0 + base + (1 if s < extra else 0)
        out.append((z0, z1))
        z0 = z1
    return out
