"""Overlapped sharded-streaming front-end (shards x z-slab streaming).

PyTorch counterpart of ``repro.stream.sharded``.  The z-axis is split
into ``n_shards`` contiguous slabs, and **every shard streams its own
sub-volume chunk by chunk** from the :class:`~repro_torch.stream.chunks
.FieldSource` exactly like the single-shard scheduler — double-buffered
loader thread, pinned buffers and a copy stream, rank-free packed keys
built on the device, incremental scatter — so no shard ever holds more
than ~2 ghost-extended chunks of field data.

The ghost plane at a *shard* boundary is owned by the neighbor shard
(lowest-base ownership, paper Sec. II-B): instead of re-reading it from
the source, shards exchange their boundary key planes through a
:class:`HaloExchange`, the host-thread analogue of the distributed
engines' one-plane exchange.  The exchange is scheduled the way the
paper's dedicated communication thread overlaps collectives with compute
(Sec. V-C):

1. at worker start each shard *eagerly publishes* its two boundary
   planes (two one-plane source reads, packed on the device) — the
   exchange is issued before any gradient kernel runs;
2. the *receive* for chunk ``i+1`` runs inside the loader thread while
   the gradient kernel computes chunk ``i``.

Comm accounting distinguishes the total halo time (``comm_s``) from the
part that ran while the device was busy (``comm_hidden_s``);
``overlap_fraction = hidden / total`` is the comm-hiding figure of merit.

Shard ``s`` runs on card ``s % N`` of the ``N`` visible cards
(:func:`_shard_devices`, the reference's ``_shard_device`` rule), on a
``torch.cuda.Stream`` of its own there, from a host thread of its own:
its pinned upload buffers, copy stream, boundary planes, key volumes and
kernel launches all stay on that card.  The dense gradient and the key
array stay on the *home* device, the run's ``device`` (the pipeline's,
and the output contract), allocated on the caller's stream: each chunk's
owned keys and packed rows (8 + 153 B a vertex) cross to home, where a
home-side stream of the shard, which waits for the caller's stream,
scatters them.  That moves fewer bytes over the link than scattering on
the shard's card and copying the chunk's sid ranges (the dense gradient
is ~206 B a vertex).  A plane published on one card carries an event of
the publisher's stream; the receiver's streams wait for it, and a plane
from another card is copied over on a link stream of the receiver's on
the publisher's card, kept alive there until the copy has run
(:func:`~repro_torch.stream.scheduler._cross`, the one place a tensor
moves between cards).  On one card, or on the CPU, every shard shares
the home device.  Output is **bit-identical** to the single-shard
streamed path: the packed ``(value, vid)`` keys are global, chunk
scatters write disjoint sids, and the back-end only ever compares orders.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import gradient as GR
from repro_torch.core.grid import Grid
from repro_torch.obs import flight as _flight
from repro_torch.obs import watchdog as _watchdog
from repro_torch.obs.metrics import global_metrics
from repro_torch.obs.trace import maybe_span

from .chunks import (Chunk, FieldSource, pack_value_keys_torch, plan_chunks,
                     plan_shards)
from .scheduler import (StreamReport, StreamResult, _adopt, _compute_chunk,
                        _cross, _current_stream, _Resident, _scatter_chunk,
                        _stage_counts, _sync, _Uploader, _using)

_HALO_TIMEOUT_S = 600.0


class HaloExchangeTimeout(RuntimeError):
    """A shard waited longer than the halo timeout for a neighbor plane
    (a neighbor worker died or never published)."""


class HaloExchange:
    """One-plane boundary key exchange between neighboring shards.

    Shard ``s`` publishes the packed keys of its ``first`` owned plane
    (consumed by shard ``s - 1`` as its above-ghost) and its ``last``
    owned plane (consumed by shard ``s + 1`` as its below-ghost).  Each
    slot is written once and read once; ``recv`` blocks on an event, so
    a receive issued from a loader thread overlaps the wait with the
    receiver's own compute.  A plane on a CUDA device carries an event
    recorded on the publisher's stream; ``recv`` makes the receiver's
    stream wait for it, and brings a plane from another card over."""

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        # (shard, side) -> [published, plane, CUDA event or None]
        self._slots = {(s, side): [threading.Event(), None, None]
                       for s in range(n_shards) for side in ("first", "last")}

    def publish(self, shard: int, side: str,
                plane_keys: torch.Tensor) -> None:
        slot = self._slots[(shard, side)]
        ready = None
        if plane_keys.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(plane_keys.device))
        slot[1], slot[2] = plane_keys, ready
        slot[0].set()
        _watchdog.progress("halo.publish")

    def recv(self, shard: int, side: str,
             timeout: float = _HALO_TIMEOUT_S, *,
             waiter: Optional[int] = None,
             plane_z: Optional[int] = None,
             device=None) -> torch.Tensor:
        """Block until neighbor ``shard`` publishes its ``side`` plane, and
        return it on ``device`` (default: where it was published), ready
        for the current stream of that device: the receiver's stream.

        On the publisher's card the receiver's stream waits for the
        publisher's event.  From another card the plane is copied on a
        link stream of the publisher's card that waits for that event,
        the receiver's stream waits for the copy, and the source plane
        is kept alive until the copy has run.

        ``waiter``/``plane_z`` are diagnostics only: on timeout the
        error names who was waiting, which neighbor never published,
        and which ghost plane the wait was for.  The wait itself runs
        under an armed watchdog lane (``halo.recv.shard<s>.<side>``)
        when a watchdog is live, so a delayed plane is *named* before
        the much longer hard timeout fires; the hard timeout also
        triggers a flight-recorder dump."""
        ev, _, _ = self._slots[(shard, side)]
        with _watchdog.lane(f"halo.recv.shard{shard}.{side}"):
            ok = ev.wait(timeout)
        _watchdog.progress("halo.recv")
        if not ok:
            who = "" if waiter is None else f"shard {waiter} waiting: "
            where = "" if plane_z is None else f" (ghost plane z={plane_z})"
            err = HaloExchangeTimeout(
                f"{who}no {side!r} boundary plane from shard {shard}"
                f"{where} after {timeout:.0f}s — did the neighbor worker "
                f"die?")
            _flight.crash_dump("halo_exchange_timeout", exc=err)
            raise err
        _, plane, ready = self._slots[(shard, side)]
        dst = plane.device if device is None else torch.device(device)
        if ready is None:
            return _cross(plane, dst)
        if dst == plane.device:
            torch.cuda.current_stream(dst).wait_event(ready)
            return plane
        link = torch.cuda.Stream(plane.device)
        link.wait_event(ready)
        return _cross(plane, dst, link)


def _shard_devices(home: torch.device) -> List[torch.device]:
    """The devices the shards run on, shard ``s`` on ``devices[s % N]``
    (the reference's ``_shard_device`` rule): every visible card in index
    order where ``home`` is a CUDA device, else ``[home]``.  No card is
    skipped and nothing falls back: a shard that cannot reach its card
    raises."""
    if home.type != "cuda":
        return [home]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _pack_plane(source: FieldSource, z: int, plane: int,
                device: torch.device) -> torch.Tensor:
    """Read one z-plane and pack its global (value, vid) keys on
    ``device``, on the current stream."""
    slab = torch.from_numpy(np.ascontiguousarray(
        source.read_slab(z, z + 1), dtype=np.float32).reshape(-1))
    return pack_value_keys_torch(slab.to(device), z * plane)


def sharded_stream_front(source: FieldSource, n_shards: int, *,
                         kernel: str = "fused",
                         chunk_z: Optional[int] = None,
                         chunk_budget: Optional[int] = None,
                         stage_report=None, device=None) -> StreamResult:
    """Run the lower-star gradient over ``source`` with ``n_shards``
    concurrently streaming z-slab shards and overlapped halo exchange.

    Same contract as :func:`~repro_torch.stream.scheduler.stream_front`
    (which is the ``n_shards == 1`` special case): dense gradient +
    global key array + :class:`StreamReport`, bit-identical to the
    in-memory path.  ``n_shards`` is clamped to the z extent; chunk knobs
    apply per shard (each shard keeps <= 2 ghost-extended chunks
    resident).  ``device`` (default ``"cuda"``) is the home device, where
    the gradient and the keys are allocated; on CUDA, shard ``s`` runs on
    card ``s % N`` of the ``N`` visible cards (:func:`_shard_devices`).
    Each ``per_shard`` entry names its ``device``, its card's
    ``peak_device_bytes`` (``torch.cuda.max_memory_allocated``; None on
    the CPU) and the ``link_bytes`` it moved between cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = _shard_devices(dev)
    grid = Grid.of(*source.dims)
    nx, ny, nz = grid.dims
    plane = nx * ny
    shards = plan_shards(nz, n_shards)
    n_shards = len(shards)
    shard_chunks: List[List[Chunk]] = [
        plan_chunks(grid.dims, chunk_z=chunk_z, chunk_budget=chunk_budget,
                    window=(z0, z1), halo_below=s > 0,
                    halo_above=s < n_shards - 1)
        for s, (z0, z1) in enumerate(shards)]

    gf = GR.alloc_gradient(grid, dev)
    offsets = GR.row_sid_offsets(grid, dev)
    keys = torch.empty(grid.nv, dtype=torch.int64, device=dev)
    # the shards' home-side streams wait for these allocations before
    # they scatter
    home = _current_stream(dev)
    exchange = HaloExchange(n_shards)
    res = _Resident()
    plane_bytes = plane * 4
    # shard workers and their loader threads cannot see the run's
    # thread-local trace activation — capture it from the stage report
    tr = getattr(stage_report, "trace", None)

    def worker(s: int) -> dict:
        # any escaping worker exception (a loader-thread failure
        # surfaces here through fut.result()) leaves a flight dump; the
        # watchdog lane names this shard if its chunk loop goes quiet
        with _flight.dump_on_error(f"stream.sharded.shard{s}"), \
                _watchdog.lane(f"stream.shard{s}"):
            d = devices[s % len(devices)]
            # cs computes on the shard's card; hs scatters on home (the
            # same stream where the shard's card is home)
            cs = hs = None
            if home is not None:
                cs = torch.cuda.Stream(d)
                hs = cs if d == dev else torch.cuda.Stream(dev)
            with _using(cs), _using(hs):
                if hs is not None:
                    hs.wait_stream(home)
                try:
                    return run_shard(s, d, cs, hs)
                finally:
                    _sync(cs)
                    _sync(hs)

    def run_shard(s: int, d: torch.device, cs, hs) -> dict:
        z0, z1 = shards[s]
        chunks = shard_chunks[s]
        st = dict(shard=s, z0=z0, z1=z1, n_chunks=len(chunks),
                  load_s=0.0, compute_s=0.0, scatter_s=0.0,
                  comm_s=0.0, comm_hidden_s=0.0, loaded_bytes=0,
                  halo_planes=0, peak_resident_field_bytes=0,
                  max_chunk_bytes=max(c.load_bytes(grid.dims)
                                      for c in chunks),
                  device=str(d), link_bytes=0)
        shard_res = _Resident()
        up = _Uploader(d, st["max_chunk_bytes"] // 4)

        # -- eager boundary publish: issue the exchange before any
        # kernel runs, so neighbor receives are satisfied ahead of need
        publish_s = 0.0
        t0 = time.perf_counter()
        for side, z, on in (("first", z0, s > 0),
                            ("last", z1 - 1, s < n_shards - 1)):
            if not on:
                continue
            with maybe_span(tr, "halo_publish", shard=s, side=side,
                            plane_z=z):
                res.add(plane_bytes)
                exchange.publish(s, side, _pack_plane(source, z, plane, d))
                res.release(plane_bytes)
            st["loaded_bytes"] += plane_bytes
            st["halo_planes"] += 1
        if st["halo_planes"]:
            publish_s = time.perf_counter() - t0
            st["comm_s"] += publish_s

        def load(c: Chunk):
            """Loader-thread body: source read + upload + halo receive for
            one chunk — the receive wait overlaps the previous chunk's
            compute (double-buffered comm)."""
            t0 = time.perf_counter()
            with maybe_span(tr, "chunk_load", shard=s, zlo=c.zlo,
                            zhi=c.zhi):
                slab = source.read_slab(c.glo, c.ghi)
                dslab = up.upload(slab)
            load_dt = time.perf_counter() - t0
            halo_lo = halo_hi = None
            recv_dt = 0.0
            if c.halo_below or c.halo_above:
                t0 = time.perf_counter()
                with _using(up.stream):
                    if c.halo_below:
                        with maybe_span(tr, "halo_recv", shard=s,
                                        neighbor=s - 1, plane_z=c.zlo - 1):
                            halo_lo = exchange.recv(s - 1, "last", waiter=s,
                                                    plane_z=c.zlo - 1,
                                                    device=d)
                    if c.halo_above:
                        with maybe_span(tr, "halo_recv", shard=s,
                                        neighbor=s + 1, plane_z=c.zhi):
                            halo_hi = exchange.recv(s + 1, "first", waiter=s,
                                                    plane_z=c.zhi, device=d)
                recv_dt = time.perf_counter() - t0
            return (slab.nbytes, dslab, halo_lo, halo_hi, up.handoff(),
                    load_dt, recv_dt)

        def neighbor_bytes(n: int) -> int:
            """Bytes of a boundary plane from shard ``n``'s card, if that
            card is not this shard's."""
            other = devices[n % len(devices)]
            return plane * 8 if other != d else 0

        t_wall = time.perf_counter()
        comm_exposed = publish_s
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix=f"shard{s}-loader"
                                ) as pool:
            for r in (res, shard_res):
                r.add(chunks[0].load_bytes(grid.dims))
            fut = pool.submit(load, chunks[0])
            for i, c in enumerate(chunks):
                _watchdog.progress(f"stream.shard{s}")
                t0 = time.perf_counter()
                nbytes, dslab, halo_lo, halo_hi, ready, load_dt, recv_dt = \
                    fut.result()
                block_dt = time.perf_counter() - t0
                st["load_s"] += load_dt
                st["comm_s"] += recv_dt
                comm_exposed += min(recv_dt, block_dt)
                st["loaded_bytes"] += nbytes
                if i + 1 < len(chunks):
                    for r in (res, shard_res):
                        r.add(chunks[i + 1].load_bytes(grid.dims))
                    fut = pool.submit(load, chunks[i + 1])

                t0 = time.perf_counter()
                with maybe_span(tr, "chunk_compute", shard=s, zlo=c.zlo,
                                zhi=c.zhi):
                    _adopt([dslab, halo_lo, halo_hi], ready, cs)
                    owned, rows = _compute_chunk(dslab, c, grid.dims, kernel,
                                                 halo_lo, halo_hi)
                    _sync(cs)
                st["compute_s"] += time.perf_counter() - t0

                if c.halo_below:
                    st["link_bytes"] += neighbor_bytes(s - 1)
                if c.halo_above:
                    st["link_bytes"] += neighbor_bytes(s + 1)

                t0 = time.perf_counter()
                with maybe_span(tr, "chunk_scatter", shard=s, zlo=c.zlo,
                                zhi=c.zhi):
                    # copied on cs, which wrote them; hs waits for the copy
                    owned, *rows = (_cross(t, dev) for t in (owned, *rows))
                    if d != dev:
                        st["link_bytes"] += sum(
                            t.numel() * t.element_size()
                            for t in (owned, *rows))
                    _scatter_chunk(grid, gf, keys, owned, rows, c, offsets)
                    _sync(hs)
                st["scatter_s"] += time.perf_counter() - t0
                for r in (res, shard_res):
                    r.release(c.load_bytes(grid.dims))
                del dslab, owned, rows
        st["wall_s"] = time.perf_counter() - t_wall
        st["comm_hidden_s"] = max(0.0, st["comm_s"] - comm_exposed)
        st["peak_resident_field_bytes"] = shard_res.peak
        st["peak_device_bytes"] = torch.cuda.max_memory_allocated(d) \
            if d.type == "cuda" else None
        return st

    t_wall = time.perf_counter()
    if n_shards == 1:
        shard_stats = [worker(0)]
    else:
        with ThreadPoolExecutor(max_workers=n_shards,
                                thread_name_prefix="shard") as pool:
            shard_stats = list(pool.map(worker, range(n_shards)))
    wall_s = time.perf_counter() - t_wall

    rep = StreamReport(
        dims=grid.dims, backend=kernel,
        n_chunks=sum(len(cs) for cs in shard_chunks),
        chunk_z=shard_chunks[0][0].nz,
        max_chunk_bytes=max(c.load_bytes(grid.dims)
                            for cs in shard_chunks for c in cs),
        key_bytes=keys.numel() * keys.element_size(), wall_s=wall_s,
        n_shards=n_shards, peak_resident_field_bytes=res.peak,
        per_shard=shard_stats)
    for st in shard_stats:
        rep.load_s += st["load_s"]
        rep.compute_s += st["compute_s"]
        rep.scatter_s += st["scatter_s"]
        rep.comm_s += st["comm_s"]
        rep.comm_hidden_s += st["comm_hidden_s"]
        rep.total_loaded_bytes += st["loaded_bytes"]
    serial = rep.load_s + rep.compute_s + rep.scatter_s + rep.comm_s
    rep.overlap_s = max(0.0, serial - rep.wall_s)
    if rep.comm_s > 0:
        rep.overlap_fraction = rep.comm_hidden_s / rep.comm_s
    halo_planes = sum(st["halo_planes"] for st in shard_stats)
    mx = global_metrics()
    mx.counter("stream.chunks").inc(rep.n_chunks)
    mx.counter("stream.loaded_bytes").inc(rep.total_loaded_bytes)
    mx.counter("halo.planes").inc(halo_planes)

    if stage_report is not None:
        _stage_counts(stage_report, rep, n_shards=n_shards)
        comm = stage_report.child("comm")
        comm.seconds = rep.comm_s
        comm.count(comm_total_s=rep.comm_s,
                   comm_hidden_s=rep.comm_hidden_s, halo_planes=halo_planes)
    return StreamResult(gf, keys, rep,
                        [c for cs in shard_chunks for c in cs])
