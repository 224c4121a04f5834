"""Double-buffered out-of-core streaming of the gradient front-end.

PyTorch counterpart of ``repro.stream.scheduler``, the analogue of the
paper's dedicated communication thread (Sec. V-C): a one-slot loader
thread prefetches chunk ``i+1`` from the
:class:`~repro_torch.stream.chunks.FieldSource` while the device computes
the lower-star gradient of chunk ``i``, so host I/O and kernel time
overlap and at most **two** ghost-extended chunks of field data are ever
resident.  Per chunk:

1. the loader reads the ghost-extended z-slab (float32 planes) into one
   of two pinned host buffers and copies it to the device on a copy
   stream of its own (``non_blocking``), so only the float32 slab crosses
   PCIe, half the bytes of its int64 keys;
2. on the device, the slab is packed into rank-free ``(value, vid)``
   int64 keys (:func:`~repro_torch.stream.chunks.pack_value_keys_torch`)
   — no global argsort, no dense rank array, no cross-chunk
   communication — and the (nzl+2, ny, nx) halo key volume is built;
3. the halo volume goes through ``kernels.ops.lower_star_rows_halo``
   (the fused CUDA kernel's halo entry by default), which returns packed
   gradient rows for the owned vertices;
4. the rows scatter into the dense device gradient
   (``GR.scatter_rows_chunk``) and the owned keys land in the dense
   device key array handed to the back-end.

The back-end consumes the key array *as* the vertex order (every
downstream comparison is order-isomorphism invariant), and
:class:`SparseOrder` translates keys back to true global ranks only for
the vertices the final diagram touches, via a counting pass per slab
(:func:`ranks_for_vids`).  The global vertex order is never materialized.

Kernel launches are asynchronous, so every timed part ends in a
synchronize of the stream it ran on: ``load_s`` covers the source read
and the host-to-device copy, ``compute_s`` the key packing and the
kernel, ``scatter_s`` the scatter.  All byte and second accounting lands
in a :class:`StreamReport`.  On the CPU (``device="cpu"``) the same code
runs without streams, pinned buffers or copies.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import gradient as GR
from repro_torch.core.grid import Grid
from repro_torch.obs import flight as _flight
from repro_torch.obs import watchdog as _watchdog
from repro_torch.obs.metrics import global_metrics
from repro_torch.obs.trace import maybe_span

from .chunks import (Chunk, FieldSource, pack_value_keys_torch, plan_chunks,
                     unpack_value_keys_torch)


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------

@dataclass
class StreamReport:
    """Machine-readable accounting of one streamed front-end run.

    ``peak_resident_field_bytes`` counts ghost-extended field slabs
    *reserved simultaneously* (the compute slab plus the prefetch slab) —
    the number the out-of-core contract bounds by ~2 chunks + ghosts; in
    a sharded run it is the concurrent total across shards, with the
    per-shard peaks in ``per_shard``.  ``key_bytes`` is the dense int64
    key array handed to the back-end.

    ``comm_s`` totals the halo-exchange work of a sharded run (boundary
    plane publishes plus neighbor-plane waits); ``comm_hidden_s`` is the
    part that ran inside the loader thread while the device computed,
    and ``overlap_fraction = comm_hidden_s / comm_s`` (None when the run
    had no communication) is the comm-hiding figure of merit."""

    dims: tuple = ()
    backend: str = ""
    n_chunks: int = 0
    chunk_z: int = 0
    max_chunk_bytes: int = 0
    peak_resident_field_bytes: int = 0
    total_loaded_bytes: int = 0
    key_bytes: int = 0
    load_s: float = 0.0
    compute_s: float = 0.0
    scatter_s: float = 0.0
    wall_s: float = 0.0
    overlap_s: float = 0.0
    n_shards: int = 1
    comm_s: float = 0.0
    comm_hidden_s: float = 0.0
    overlap_fraction: Optional[float] = None
    per_shard: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in self.__dict__.items()}


class _Resident:
    """Running/peak byte counter for reserved field slabs (thread-safe:
    sharded runs reserve from every shard worker concurrently)."""

    def __init__(self):
        self.cur = 0
        self.peak = 0
        self._lock = threading.Lock()

    def add(self, n: int) -> None:
        with self._lock:
            self.cur += n
            self.peak = max(self.peak, self.cur)

    def release(self, n: int) -> None:
        with self._lock:
            self.cur -= n


# --------------------------------------------------------------------------
# host -> device, per-chunk compute and scatter (shared with sharded.py)
# --------------------------------------------------------------------------

def _sync(stream: Optional[torch.cuda.Stream]) -> None:
    """End a timed part: wait for the work queued on ``stream``."""
    if stream is not None:
        stream.synchronize()


def _current_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def _using(stream: Optional[torch.cuda.Stream]):
    """``torch.cuda.stream(stream)``, or nothing on the CPU."""
    return torch.cuda.stream(stream) if stream is not None else nullcontext()


class _Uploader:
    """Host slabs to the device, for one loader thread.

    On CUDA: two pinned host buffers used in turns, and a copy stream; a
    buffer is refilled only after its previous copy has finished.  On the
    CPU the slab itself, as a tensor."""

    def __init__(self, device: torch.device, max_elems: int):
        self.device = device
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self._bufs = [torch.empty(max_elems, dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self._copied: List[Optional[torch.cuda.Event]] = [None, None]
            self._next = 0

    def upload(self, slab: np.ndarray) -> torch.Tensor:
        """The slab on the device (float32, flat).  Returns once the copy
        has finished; the tensor belongs to the copy stream."""
        if self.stream is None:
            return torch.from_numpy(
                np.ascontiguousarray(slab, dtype=np.float32).reshape(-1))
        b, self._next = self._next, 1 - self._next
        if self._copied[b] is not None:
            self._copied[b].synchronize()
        buf = self._bufs[b][:slab.size]
        np.copyto(buf.numpy(), slab.reshape(-1))
        with torch.cuda.stream(self.stream):
            dev = buf.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._copied[b] = ev
        ev.synchronize()
        return dev

    def handoff(self) -> Optional[torch.cuda.Event]:
        """An event after everything queued on the copy stream so far (the
        copy and any halo waits) — what the compute stream waits on."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


def _adopt(tensors, ready: Optional[torch.cuda.Event],
           stream: Optional[torch.cuda.Stream]) -> None:
    """Make ``stream`` wait for ``ready`` and keep the allocator from
    reusing ``tensors`` (made on other streams) before ``stream`` is done
    with them."""
    if stream is None:
        return
    if ready is not None:
        stream.wait_event(ready)
    for t in tensors:
        if t is not None:
            t.record_stream(stream)


def _ext_volume(keys_slab: torch.Tensor, c: Chunk, dims,
                halo_lo: Optional[torch.Tensor] = None,
                halo_hi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nzl+2, ny, nx) halo key volume of chunk ``c`` (-1 at the grid
    boundary).  At a *shard* boundary the ghost plane was not loaded from
    the source: it is the neighbor's boundary key plane received through
    the halo exchange (``halo_lo`` / ``halo_hi``)."""
    nx, ny, _ = dims
    k3 = keys_slab.reshape(c.ghi - c.glo, ny, nx)
    ext = torch.empty((c.nz + 2, ny, nx), dtype=torch.int64,
                      device=keys_slab.device)
    ext[1:-1] = k3[c.zlo - c.glo: c.zhi - c.glo]
    if c.halo_below:
        ext[0] = halo_lo.reshape(ny, nx)
    elif c.glo < c.zlo:
        ext[0] = k3[0]
    else:
        ext[0] = -1
    if c.halo_above:
        ext[-1] = halo_hi.reshape(ny, nx)
    elif c.ghi > c.zhi:
        ext[-1] = k3[-1]
    else:
        ext[-1] = -1
    return ext


def _compute_chunk(slab: torch.Tensor, c: Chunk, dims, kernel: str,
                   halo_lo=None, halo_hi=None):
    """(owned keys, packed rows) of one chunk, from its float32 slab on
    the device."""
    from repro_torch.kernels import ops
    nx, ny, _ = dims
    plane = nx * ny
    kslab = pack_value_keys_torch(slab, c.glo * plane)
    ext = _ext_volume(kslab, c, dims, halo_lo=halo_lo, halo_hi=halo_hi)
    rows = ops.lower_star_rows_halo(ext, backend=kernel)
    lo = (c.zlo - c.glo) * plane
    return kslab[lo: lo + c.nz * plane], rows


def _scatter_chunk(grid: Grid, gf: GR.GradientField, keys: torch.Tensor,
                   owned_keys: torch.Tensor, rows, c: Chunk,
                   offsets) -> None:
    v0 = c.vid0(grid.dims)
    GR.scatter_rows_chunk(grid, gf, *rows, v0, offsets=offsets)
    keys[v0: v0 + owned_keys.numel()] = owned_keys


def _stage_counts(stage_report, rep: StreamReport, **extra) -> None:
    for name in ("load", "compute", "scatter"):
        ch = stage_report.child(name)
        ch.seconds = getattr(rep, name + "_s")
    stage_report.count(
        chunks=rep.n_chunks,
        peak_resident_field_bytes=rep.peak_resident_field_bytes,
        loaded_bytes=rep.total_loaded_bytes,
        max_chunk_bytes=rep.max_chunk_bytes,
        overlap_s=rep.overlap_s, **extra)


# --------------------------------------------------------------------------
# streamed front-end
# --------------------------------------------------------------------------

@dataclass
class StreamResult:
    """Front-end handoff: dense gradient + key array + accounting."""

    gf: GR.GradientField
    keys: torch.Tensor        # (nv,) int64 rank-free keys (back-end order)
    report: StreamReport
    chunks: List[Chunk] = field(default_factory=list)

    def values_for_vids(self, vids) -> torch.Tensor:
        """Field values of ``vids``, recovered from the packed keys —
        the field itself was never materialized (-0.0 reads as +0.0)."""
        vids = torch.as_tensor(vids, dtype=torch.int64,
                               device=self.keys.device)
        return unpack_value_keys_torch(self.keys[vids])


def stream_front(source: FieldSource, *, kernel: str = "fused",
                 chunk_z: Optional[int] = None,
                 chunk_budget: Optional[int] = None,
                 stage_report=None, device=None) -> StreamResult:
    """Run the lower-star gradient over ``source`` chunk by chunk.

    kernel: a streaming backend of ``lower_star_rows_halo`` ("fused",
    "prepass", "torch").  Exactly one of ``chunk_z`` (owned planes per
    chunk) / ``chunk_budget`` (bytes of loaded field per chunk) selects
    the decomposition.  ``device`` defaults to ``"cuda"``; the gradient
    and the keys are allocated there and never leave it.
    ``stage_report``, if given, receives load/compute/scatter child
    timings and the headline counters."""
    dev = torch.device("cuda" if device is None else device)
    grid = Grid.of(*source.dims)
    nx, ny, nz = grid.dims
    chunks = plan_chunks(grid.dims, chunk_z=chunk_z,
                         chunk_budget=chunk_budget)

    gf = GR.alloc_gradient(grid, dev)
    offsets = GR.row_sid_offsets(grid, dev)
    keys = torch.empty(grid.nv, dtype=torch.int64, device=dev)
    rep = StreamReport(
        dims=grid.dims, backend=kernel, n_chunks=len(chunks),
        chunk_z=chunks[0].nz,
        max_chunk_bytes=max(c.load_bytes(grid.dims) for c in chunks),
        key_bytes=keys.numel() * keys.element_size())
    res = _Resident()
    cs = _current_stream(dev)
    up = _Uploader(dev, rep.max_chunk_bytes // 4)
    # worker threads cannot see the run's thread-local activation —
    # they capture the Trace (or None) from the stage report instead
    tr = getattr(stage_report, "trace", None)

    def load(c: Chunk):
        t0 = time.perf_counter()
        with maybe_span(tr, "chunk_load", zlo=c.zlo, zhi=c.zhi):
            slab = source.read_slab(c.glo, c.ghi)
            dslab = up.upload(slab)
        return slab.nbytes, dslab, up.handoff(), time.perf_counter() - t0

    t_wall = time.perf_counter()
    # a loader-thread failure surfaces at fut.result(): any escaping
    # exception leaves a flight dump, and the chunk loop beats a
    # watchdog lane so a silent wedge (a blocking source) gets named
    with _flight.dump_on_error("stream.scheduler"), \
            _watchdog.lane("stream.chunks"), \
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="stream-loader") as pool:
        res.add(chunks[0].load_bytes(grid.dims))
        fut = pool.submit(load, chunks[0])
        for i, c in enumerate(chunks):
            _watchdog.progress("stream.chunks")
            nbytes, dslab, ready, dt = fut.result()
            rep.load_s += dt
            rep.total_loaded_bytes += nbytes
            if i + 1 < len(chunks):
                # double buffer: reserve + prefetch the next chunk while
                # this one computes (the "communication thread")
                res.add(chunks[i + 1].load_bytes(grid.dims))
                fut = pool.submit(load, chunks[i + 1])

            t0 = time.perf_counter()
            with maybe_span(tr, "chunk_compute", zlo=c.zlo, zhi=c.zhi):
                _adopt([dslab], ready, cs)
                owned, rows = _compute_chunk(dslab, c, grid.dims, kernel)
                _sync(cs)
            rep.compute_s += time.perf_counter() - t0

            t0 = time.perf_counter()
            with maybe_span(tr, "chunk_scatter", zlo=c.zlo, zhi=c.zhi):
                _scatter_chunk(grid, gf, keys, owned, rows, c, offsets)
                _sync(cs)
            rep.scatter_s += time.perf_counter() - t0
            res.release(c.load_bytes(grid.dims))
            del dslab, owned, rows

    rep.wall_s = time.perf_counter() - t_wall
    rep.peak_resident_field_bytes = res.peak
    serial = rep.load_s + rep.compute_s + rep.scatter_s
    rep.overlap_s = max(0.0, serial - rep.wall_s)
    mx = global_metrics()
    mx.counter("stream.chunks").inc(rep.n_chunks)
    mx.counter("stream.loaded_bytes").inc(rep.total_loaded_bytes)

    if stage_report is not None:
        _stage_counts(stage_report, rep)
    return StreamResult(gf, keys, rep, chunks)


# --------------------------------------------------------------------------
# key -> rank translation for the final diagram
# --------------------------------------------------------------------------

def ranks_for_vids(keys: torch.Tensor, vids,
                   slab: int = 1 << 20) -> torch.Tensor:
    """Exact global ranks of ``vids`` under the (value, vid) order.

    rank(v) = #{u : key[u] < key[v]} — counted against the key array one
    O(slab) piece at a time (``torch.sort`` of the piece, one
    ``torch.searchsorted`` per piece), so no global argsort/permutation
    is ever built.  Keys are injective, so these ranks equal
    ``vertex_order(f)[vids]`` bit for bit."""
    vids = torch.as_tensor(vids, dtype=torch.int64, device=keys.device)
    qk = keys[vids]
    counts = torch.zeros(len(vids), dtype=torch.int64, device=keys.device)
    for lo in range(0, len(keys), slab):
        counts += torch.searchsorted(torch.sort(keys[lo:lo + slab]).values,
                                     qk)
    return counts


class SparseOrder:
    """Tensor-like vertex order defined only at registered vertices.

    Stands in for the dense ``order`` tensor on a streamed
    :class:`~repro_torch.core.diagram.Diagram`: indexing (``order[vids]``,
    any shape) answers exact global ranks for the critical-simplex
    vertices the diagram touches and raises ``KeyError`` elsewhere — by
    construction the streamed pipeline never needs the rest."""

    def __init__(self, nv: int, vids, ranks):
        vids = torch.as_tensor(vids, dtype=torch.int64)
        ranks = torch.as_tensor(ranks, dtype=torch.int64, device=vids.device)
        srt = torch.argsort(vids)
        self.nv = int(nv)
        self._vids = vids[srt]
        self._ranks = ranks[srt]

    @classmethod
    def from_keys(cls, keys: torch.Tensor, vids) -> "SparseOrder":
        vids = torch.unique(torch.as_tensor(vids, dtype=torch.int64,
                                            device=keys.device))
        return cls(len(keys), vids, ranks_for_vids(keys, vids))

    @property
    def device(self) -> torch.device:
        return self._vids.device

    def __len__(self) -> int:
        return self.nv

    def __getitem__(self, idx) -> torch.Tensor:
        a = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        n = len(self._vids)
        if n == 0:
            if a.numel():
                raise KeyError(f"SparseOrder: rank not registered for "
                               f"vertices {a.reshape(-1)[:8].tolist()}")
            return torch.zeros_like(a)
        pc = torch.searchsorted(self._vids, a).clamp(max=n - 1)
        hit = self._vids[pc] == a
        if not bool(hit.all()):
            missing = torch.unique(a[~hit])
            raise KeyError(
                f"SparseOrder: rank not registered for vertices "
                f"{missing[:8].tolist()}{'...' if len(missing) > 8 else ''}")
        return self._ranks[pc]


def diagram_vertices(grid: Grid, pairs: Dict[int, torch.Tensor],
                     essential: Dict[int, torch.Tensor]) -> torch.Tensor:
    """All vertex ids the final diagram will ever look up: the vertices
    of every paired and essential critical simplex (sorted, unique)."""
    vs = []
    dev = None
    for p, pr in pairs.items():
        dev = pr.device
        if len(pr):
            vs.append(grid.simplex_vertices(p, pr[:, 0].long()).reshape(-1))
            vs.append(grid.simplex_vertices(p + 1, pr[:, 1].long())
                      .reshape(-1))
    for p, es in essential.items():
        dev = es.device
        if len(es):
            vs.append(grid.simplex_vertices(p, es.long()).reshape(-1))
    if not vs:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    return torch.unique(torch.cat(vs).long())
