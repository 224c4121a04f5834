#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the repository root, one GPU
    python3 chip_smoke.py --timing-of DIR  # the timing phase alone, on DIR

Phases (one line each; any failing phase makes the script exit non-zero):

1. build    — both CUDA sources with nvcc from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, started together); prints the
              build seconds, ptxas' registers / stack / spills of each of
              the six instantiations (fused whole-grid and halo entries,
              prepass; int32 and int64), the launch shape, shared memory
              and resident blocks per SM the runtime reports, and
              ``nvidia-smi --query-gpu=name,power.limit``.
2. kernels  — the fused and prepass kernels bit-equal to the plain PyTorch
              version on the card (tolerance 0: all outputs are integers)
              over asymmetric, thin, 2-D and 1-D grids, int32 and int64
              ranks, 127^3 (packed-key grid) and 128^3 (first column-key
              grid), a batch of 3, 256^3, and the edges of the kernels'
              128-vertex tiles: dims that are no multiple of it, nx = ny =
              1, batches of 3 whose tiles cross a member's end, and int64
              ranks above 2^31.  Then the fused kernel's halo entry on the
              (nzl+2, ny, nx) key volumes of streamed chunks (int64
              (value, vid) keys), bit-equal to the plain version and to
              the whole-grid fused rows of the same slab under
              ``vertex_order``: first, interior and last chunks of 256^3,
              a chunk that is the whole grid (two -1 ghosts), nzl = 1,
              nx = ny = 1, ragged (129, 7, 5) slabs, many tied values and
              keys above 2^62.
3. main     — the main path: ``PersistencePipeline().run`` on ``isabel``
              256^3 and ``random`` 128^3 through the ``fused`` kernel, and
              the ``prepass`` backend on ``random`` 128^3 as its
              cross-check, plus ``run_batch`` of 3 same-shape fields.  The
              launch counters are zeroed just before and read just after;
              both kernels must have launched and the plain version must
              not have run on the card.  Gradient check: the critical
              counts have Euler characteristic 1 and match the diagram;
              then ``check_gradient_valid`` on the 256^3 gradient.
4. stream   — the streamed path: ``diagram_stream(ArraySource)`` on
              ``isabel`` 256^3 with ``chunk_z=32`` (8 chunks), its payload
              byte-equal to the in-memory main-path result of phase 3, its
              ``StreamReport`` and peak device memory, with the launch
              counters zeroed just before and read just after (the halo
              entry launched once per chunk, the plain version never);
              the sharded engine (4 shards, ``distributed=False``) on
              ``random`` 128^3 end to end (payload equal to phase 3's) and
              on ``isabel`` 256^3 front-end only (gradient and keys equal
              to ``stream_front``'s); and out of core, ``stream_front``
              over ``FunctionSource.synthetic("random", 512^3)`` with the
              default 64 MiB chunk budget (critical counts with Euler
              characteristic 1).  Nothing here is caught.
5. approx   — approximation at ``isabel`` 256^3: the ``Hierarchy`` on
              the card (levels, dims and bounds equal to the CPU's; the
              level-1 ``block_minmax`` and the cascade timed beside their
              byte bounds and beside ``max_pool3d``), ``approximate`` at
              each of the 7 coarse levels with the bottleneck guarantee
              checked against the exact 256^3 diagram of phase 3 for the
              dimensions whose pair counts fit GUARANTEE_BUDGET (the rest
              logged as skipped), and in full on ``wavelet`` 64^3;
              ``epsilon`` picks the expected level; ``refine`` under a
              deadline and to the end at 128^3 (equal to ``run`` of the
              progressive request); a ``MemmapSource`` of the field at
              level 1 through the halo entry, equal to the in-memory
              payload.  Launch counters zeroed just before and read just
              after: the fused kernel once per level, the plain version
              never on the card.
6. serve    — ``TopoService(cache=True)`` on the card: four same-shape
              64^3 fields from client threads in one batched dispatch
              (equal to ``run``), resubmitted as cache hits that launch no
              kernel, a progressive 256^3 submit with ``deadline_s``
              (preview first), a later ``epsilon`` submit served from the
              refined entry, a traced request (one span per stage), a
              ``wire=True`` payload, and ``stats_payload``.
7. cpu      — diagrams on the card equal those on the CPU (32^3 wavelet,
              32^3 random, a thin 2-D grid).
8. timing   — CUDA-event times of ``fused`` and ``prepass`` at 256^3
              (``isabel``, ``random``) and 512^3 (``random``) and of the
              plain version at 256^3, each beside its bound (the longer of
              its bytes over 3.35 TB/s and the integer operations the
              pairing needs on this run's data over 33.5 T/s), the pops
              per vertex and the warp divergence factor of that data; and
              the halo entry per chunk of ``isabel`` 256^3 (int64 keys,
              ``chunk_z=32``) and over the whole grid, beside its bound
              (8 B read and 153 B written per owned vertex plus the ghost
              planes) and the plain version's time on the same chunks.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script prints no result and exits non-zero.

``--timing-of DIR`` runs only phase 8 (without the plain version) on the
port in another tree DIR, for instance the parent commit unpacked with
``git archive`` into a git-ignored directory; it prints no result lines.
To compare two trees, time them in turns in one call on one card (A, B,
B, A).
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
# the guide's 67 TFLOP/s non-tensor fp32 rate; an H100 SM issues int32 on
# 64 of its 128 lanes, so integer work peaks at half of it
INT_OPS_PER_S = 67e12 / 2
SEED = 0


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# operation and byte counts of one lower-star pairing launch
# --------------------------------------------------------------------------

def io_bytes(n, rank_bytes, prepass, ghosts=0):
    """Bytes a pairing launch must move: each input read once (ranks,
    plus the (n, 27) tensor for the prepass kernel, plus ``ghosts`` ghost
    keys for the halo entry), each output written once (74 + 74 + 1 + 4
    B/vertex)."""
    return (n * rank_bytes * (28 if prepass else 1) + ghosts * rank_bytes
            + n * (74 + 74 + 1 + 4))


def _warp_spread(x):
    """Sum over the whole warps of 32 consecutive entries of x of
    (max x 32 / sum)."""
    w = x[:len(x) // 32 * 32].reshape(-1, 32).double()
    return float((w.max(1).values * 32 / w.sum(1)).sum())


def pairing_work(status, vstat, chunk=1 << 22):
    """{ops, ops_v1, pops_per_vertex, divergence, divergence_regrouped}
    of the pairing over these outputs.

    ``ops`` counts the integer operations the pairing needs on this run's
    data, whatever a kernel's design: per vertex 14 compares that find the
    lower ones among the 14 neighbours the star's rows reach, 36 + 2 x 24
    ANDs that decide which triangle and tet rows lie in the lower star, the
    sort of each lower-star row's key (1 compare for a triangle, 3 for a
    tet), and per pop one operation for each lower-star row still
    available (its test as a candidate, with its compare in the argmin):
    the lower edges for the vertex pop, then, counting every pair pop
    before every critical pop (the order with the fewest), the rows left.
    ``ops_v1`` counts the first port's loop the way its own model did: a
    setup of ~790, then per pop a 2-op scan of all 74 rows plus ~24 for
    every row still available.

    Pops per vertex are the vertex pop plus every pair and critical pop.
    ``divergence`` is the mean over warps of 32 consecutive vertices of
    (max pops x 32 / sum of pops): the loop trips a warp runs over the
    trips its threads need; ``divergence_regrouped`` is the same over the
    warps the kernels form (each block of 128 ordered by its number of
    lower neighbours, the count of lower edge rows).  Counted in vertex
    chunks (multiples of 128)."""
    import torch
    n = status.shape[0]
    ops = ops_v1 = 0
    pops_sum, div, divr, warps = 0, 0.0, 0.0, 0
    for i in range(0, n, chunk):
        st, vs = status[i:i + chunk], vstat[i:i + chunk]
        low = st != 0
        lower = low.sum(1)
        lower_edges = low[:, :14].sum(1)
        has_edge = (vs == 2).long()
        pairs = (st == 3).sum(1) - has_edge
        crits = (st == 4).sum(1)
        a0 = lower - has_edge
        iters = pairs + crits + 1
        avail_sum = (pairs * a0 - pairs * (pairs - 1)) \
            + (crits * (a0 - 2 * pairs) - crits * (crits - 1) // 2)
        ops_v1 += 790 * len(st) + int((148 * iters + 24 * avail_sum).sum())
        ops += (14 + 36 + 48) * len(st) + int(
            (low[:, 14:50].sum(1) + 3 * low[:, 50:].sum(1) + lower_edges
             + avail_sum).sum())
        pops = pairs + crits + 1
        pops_sum += int(pops.sum())
        div += _warp_spread(pops)
        m = len(pops) // 128 * 128
        order = torch.argsort(lower_edges[:m].reshape(-1, 128), dim=1,
                              stable=True)
        order = (order + torch.arange(0, m, 128, device=order.device)[:, None]
                 ).reshape(-1)
        divr += _warp_spread(pops[:m][order])
        warps += len(pops) // 32
    return dict(ops=ops, ops_v1=ops_v1, pops_per_vertex=pops_sum / n,
                divergence=div / max(warps, 1),
                divergence_regrouped=divr / max(n // 128 * 4, 1))


def bound_ms(work):
    """The least time for ``work``: its bytes over the memory rate or the
    operations it needs over the integer rate, whichever is longer."""
    t_b = work["bytes"] / HBM_BYTES_PER_S * 1e3
    t_o = work["ops"] / INT_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` launches (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def ptxas_report(log_text):
    """{(halo, ranks): {registers, stack, spill_stores, spill_loads}} of
    each kernel instantiation in one source's ``ptxas -v`` log (``halo``:
    the fused kernel's halo entry, from the template's bool argument)."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"I([a-z])(?:Lb([01])E)?E", m.group(1))
            cur = (t.group(2) == "1",
                   "int32" if t.group(1) == "i" else "int64")
            out[cur] = {}
        elif cur and "stack frame" in line:
            st, ss, sl = (int(x) for x in re.findall(r"(\d+) bytes", line))
            out[cur].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif cur and "Used" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) reg",
                                                  line).group(1))
    return out


def phase_build(smi):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import lower_star as LS
    t0 = time.perf_counter()
    info = build.build_all()
    secs = time.perf_counter() - t0
    log("build", seconds=round(secs, 3),
        per_source={k: round(v["seconds"], 3) for k, v in info.items()},
        card=repr(smi))
    report = {}
    for name, v in info.items():
        for (halo, ranks), r in ptxas_report(v["log"]).items():
            kname = name + "_halo" if halo else name
            dtype = torch.int32 if ranks == "int32" else torch.int64
            r.update(LS.kernel_attrs(kname, dtype))
            report[(kname, ranks)] = r
            log("ptxas", kernel=kname, ranks=ranks, **r)
    if len(report) != 6:
        raise AssertionError(f"expected 6 kernel instantiations, got "
                             f"{sorted(report)}")
    return report


def _rows_equal(got, want):
    """Max |got - want| over the four row outputs (0 when bit-equal)."""
    import torch
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max())
                  if a.numel() else 0)
        if not torch.equal(a, b):
            raise AssertionError("kernel rows differ from the plain version")
    return err


def phase_kernels():
    import torch
    from repro_torch.core.gradient import neighbor_orders
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i32, i64, big = torch.int32, torch.int64, 3 << 31
    # (dims, batch, rank dtype, offset added to every rank)
    cases = [((5, 3, 7), 1, i32, 0), ((5, 3, 7), 1, i64, 0),
             ((33, 17, 9), 1, i32, 0), ((1, 5, 6), 1, i32, 0),
             ((7, 5, 1), 1, i64, 0), ((64, 1, 48), 1, i32, 0),
             ((16,), 1, i64, 0), ((40, 30, 20), 3, i32, 0),
             ((127, 127, 127), 1, i32, 0), ((128, 128, 128), 1, i32, 0),
             ((256, 256, 256), 1, i32, 0),
             # tile edges: no multiple of 128, nx = ny = 1, tiles that
             # cross a batch member's end, int64 ranks above 2^31
             ((129, 7, 5), 1, i32, 0), ((1, 1, 300), 1, i32, 0),
             ((1, 1, 300), 1, i64, big), ((7, 6, 5), 3, i32, 0),
             ((33, 17, 9), 1, i64, big), ((40, 30, 20), 3, i64, big),
             ((129, 1, 1), 3, i64, big),
             # the approximation levels of 256^3 below 128^3 and the
             # service's batch of four 64^3 fields
             ((64, 64, 64), 1, i32, 0), ((64, 64, 64), 4, i32, 0),
             ((32, 32, 32), 1, i32, 0), ((16, 16, 16), 1, i32, 0),
             ((8, 8, 8), 1, i32, 0), ((4, 4, 4), 1, i32, 0),
             ((2, 2, 2), 1, i32, 0)]
    max_err = 0
    for dims, B, dtype, offset in cases:
        g = Grid.of(*dims)
        f = torch.randn((B, g.nv), generator=gen, device="cuda")
        o = torch.stack([vertex_order(fb) for fb in f])
        nb = torch.cat([neighbor_orders(g, ob) for ob in o])
        want = ref.lower_star_gradient_torch(nb, o.reshape(-1),
                                             rank_bound=g.nv)
        o = (o + offset).to(dtype)
        nb = torch.cat([neighbor_orders(g, ob) for ob in o])
        # int64 ranks reach the kernels only when the bound forbids int32
        kb = g.nv + offset if dtype == torch.int32 else 2 ** 40
        fused = LS.fused_lower_star_gradient(g, o, rank_bound=kb)
        pre = LS.lower_star_gradient_prepass(nb, o.reshape(-1), rank_bound=kb)
        torch.cuda.synchronize()
        err = max(_rows_equal(fused, want), _rows_equal(pre, want))
        max_err = max(max_err, err)
        log("kernels", dims=dims, batch=B, ranks=str(dtype).split(".")[-1],
            offset=offset, packed_keys=ref.use_packed_keys(g.nv),
            max_abs_err=err)
        del f, o, nb, want, fused, pre
    torch.cuda.empty_cache()
    return max_err


def _chunk_ext(keys, c, dims):
    """The (nzl+2, ny, nx) halo key volume of chunk ``c`` of a field whose
    (value, vid) keys are ``keys``, as the streaming engine builds it."""
    from repro_torch.stream.scheduler import _ext_volume
    plane = dims[0] * dims[1]
    return _ext_volume(keys[c.glo * plane: c.ghi * plane], c, dims)


def phase_halo_kernels(isabel_256):
    """The fused kernel's halo entry on streamed chunks: bit-equal to the
    plain version on the same ext volume, and to the whole-grid fused rows
    of the same slab under ``vertex_order`` (order-isomorphic keys)."""
    import torch
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ops
    from repro_torch.stream import pack_value_keys_torch, plan_chunks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # (dims, chunk_z, field, chunks): "ends" takes the first, a middle
    # and the last chunk
    cases = [((256, 256, 256), 32, "isabel", "ends"),
             # the memmapped approximation level 1 of isabel 256^3
             ((128, 128, 128), 32, "isabel/2", "all"),
             ((64, 48, 40), 8, "normal", "all"),
             ((33, 17, 9), 9, "normal", "all"),    # one chunk, two -1 ghosts
             ((40, 30, 20), 1, "normal", "all"),   # nzl = 1
             ((1, 1, 300), 64, "normal", "all"),   # nx = ny = 1
             ((129, 7, 5), 2, "normal", "all"),    # ragged tiles
             ((64, 64, 32), 8, "ties", "all"),     # the vid decides
             ((48, 40, 24), 6, "positive", "all")]  # keys above 2^62
    max_err = 0
    for dims, cz, kind, which in cases:
        g = Grid.of(*dims)
        if kind == "isabel":
            f = torch.from_numpy(isabel_256).cuda()
        elif kind == "isabel/2":
            f = torch.from_numpy(isabel_256).cuda().reshape(
                (256,) * 3)[::2, ::2, ::2].reshape(-1)
        else:
            f = torch.randn(g.nv, generator=gen, device="cuda")
            if kind == "ties":
                f = torch.floor(f * 2)
            elif kind == "positive":
                f = f.abs() + 1
        keys = pack_value_keys_torch(f, 0)
        if kind == "positive" and int(keys.min()) <= 2 ** 62:
            raise AssertionError("positive values must give keys > 2^62")
        whole = LS.fused_lower_star_gradient(g, vertex_order(f))
        chunks = plan_chunks(g.dims, chunk_z=cz)
        if which == "ends":
            chunks = [chunks[0], chunks[len(chunks) // 2], chunks[-1]]
        plane = g.dims[0] * g.dims[1]
        for c in chunks:
            ext = _chunk_ext(keys, c, g.dims)
            got = LS.fused_rows_from_halo_volume(ext)
            plain = ops.lower_star_rows_halo(ext, backend="torch")
            sl = tuple(t[c.zlo * plane: c.zhi * plane] for t in whole)
            torch.cuda.synchronize()
            err = max(_rows_equal(got, plain), _rows_equal(got, sl))
            max_err = max(max_err, err)
            log("kernels", entry="halo", dims=dims, field=kind,
                chunk=(c.zlo, c.zhi), ghosts=("data" if c.glo < c.zlo
                                              else "-1",
                                              "data" if c.ghi > c.zhi
                                              else "-1"),
                keys=(int(ext[1:-1].min()), int(ext.max())),
                max_abs_err=err)
            del ext, got, plain, sl
        del f, keys, whole
    torch.cuda.empty_cache()
    return max_err


def _check_result(res, grid):
    """Euler characteristic of the critical counts is 1, and every
    critical simplex is in the diagram once (a pair end or a class)."""
    crit = {k: int(res.stats[f"n_critical_d{k}"]) for k in range(grid.dim + 1)}
    chi = sum((-1) ** k * c for k, c in crit.items())
    if chi != 1:
        raise AssertionError(f"critical Euler characteristic {chi} != 1")
    arrs = res.arrays()
    for k in range(grid.dim + 1):
        n = len(arrs[f"d{k}.essential_sids"])
        n += len(arrs[f"d{k}.pairs_sids"]) if k < grid.dim else 0
        n += len(arrs[f"d{k - 1}.pairs_sids"]) if k else 0
        if n != crit[k]:
            raise AssertionError(f"dim {k}: {crit[k]} critical simplices, "
                                 f"{n} in the diagram")
    for k in range(grid.dim):
        pts = res.pairs(k, space="order")
        if len(pts) and not (pts[:, 1] >= pts[:, 0]).all():
            raise AssertionError(f"dim {k}: a pair dies before it is born")
    return crit


def _stage_line(res):
    return {k: round(v, 4) for k, v in res.stats.items()
            if isinstance(v, float)}


def phase_main(isabel_256):
    import numpy as np
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.pipeline import PersistencePipeline, TopoRequest

    runs = [("isabel", (256, 256, 256), "fused"),
            ("random", (128, 128, 128), "fused"),
            ("random", (128, 128, 128), "prepass")]
    fields = {(n, d): make_field(n, d, seed=SEED) for n, d, _ in runs
              if n != "isabel"}
    fields[("isabel", (256, 256, 256))] = isabel_256
    batch_dims = (64, 64, 64)
    batch = [make_field(n, batch_dims, seed=s)
             for n, s in (("random", 1), ("wavelet", 2), ("magnetic", 3))]
    torch.cuda.synchronize()

    for k in LS.LAUNCHES:
        LS.LAUNCHES[k] = 0
    ref.CUDA_CALLS["lower_star_gradient_torch"] = 0
    results = {}
    for name, dims, backend in runs:
        t0 = time.perf_counter()
        res = PersistencePipeline(backend).run(
            TopoRequest(field=fields[(name, dims)], grid=Grid.of(*dims)))
        results[(name, dims, backend)] = (res, time.perf_counter() - t0)
    t0 = time.perf_counter()
    batched = PersistencePipeline().run_batch(
        [TopoRequest(field=f, grid=Grid.of(*batch_dims)) for f in batch])
    batch_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain_on_card = ref.CUDA_CALLS["lower_star_gradient_torch"]

    for (name, dims, backend), (res, secs) in results.items():
        crit = _check_result(res, Grid.of(*dims))
        log("main", field=name, dims=dims, backend=backend,
            seconds=round(secs, 3), critical=crit,
            pairs={p: len(res.pairs(p)) for p in range(len(dims))},
            betti=res.betti(), d1_rounds=res.stats.get("d1_rounds"),
            stages=_stage_line(res))
    a = results[("random", (128, 128, 128), "fused")][0]
    b = results[("random", (128, 128, 128), "prepass")][0]
    for p in a.homology_dims:
        if not np.array_equal(a.pairs(p, space="order"),
                              b.pairs(p, space="order")):
            raise AssertionError(f"prepass and fused diagrams differ in {p}")
    singles = [PersistencePipeline().run(
        TopoRequest(field=f, grid=Grid.of(*batch_dims))) for f in batch]
    for x, y in zip(batched, singles):
        _check_result(x, Grid.of(*batch_dims))
        for p in x.homology_dims:
            if not np.array_equal(x.pairs(p, space="order"),
                                  y.pairs(p, space="order")):
                raise AssertionError("run_batch differs from run")
    log("main", run_batch=len(batch), dims=batch_dims,
        seconds=round(batch_s, 3), launches=launches,
        plain_on_card=plain_on_card)
    if launches["fused"] < 1 or launches["prepass"] < 1:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if plain_on_card:
        raise AssertionError("the plain version ran on the card path")
    return launches, fields, {k: r for k, (r, _) in results.items()}


def _zero_counts():
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    for k in LS.LAUNCHES:
        LS.LAUNCHES[k] = 0
    ref.CUDA_CALLS["lower_star_gradient_torch"] = 0


def _read_counts(n_chunks, what):
    """The launch counts of a streamed run: the halo entry once per chunk,
    no other kernel, the plain version never."""
    import torch
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    if launches != {"fused": 0, "prepass": 0, "fused_halo": n_chunks}:
        raise AssertionError(f"{what}: launches {launches}, want the halo "
                             f"entry once per chunk ({n_chunks})")
    if plain:
        raise AssertionError(f"{what}: the plain version ran on the card")
    return launches, plain


def _report_line(rep):
    keys = ("n_chunks", "chunk_z", "n_shards", "load_s", "compute_s",
            "scatter_s", "wall_s", "overlap_s", "comm_s", "comm_hidden_s",
            "overlap_fraction", "max_chunk_bytes",
            "peak_resident_field_bytes", "total_loaded_bytes", "key_bytes")
    return {k: getattr(rep, k) for k in keys}


def _same_front(a, b, what):
    import torch
    for name in ("pair_up", "pair_down", "crit"):
        da, db = getattr(a.gf, name), getattr(b.gf, name)
        if sorted(da) != sorted(db) or not all(
                torch.equal(da[k], db[k]) for k in da):
            raise AssertionError(f"{what}: {name} differs")
    if not torch.equal(a.keys, b.keys):
        raise AssertionError(f"{what}: keys differ")


def phase_stream(fields, results):
    """The streamed path at full size: ``diagram_stream`` on ``isabel``
    256^3, the sharded engine, and an out-of-core 512^3 front-end.
    Returns the halo entry's launches in the ``diagram_stream`` run."""
    import torch
    from repro_torch.core.gradient import euler_characteristic
    from repro_torch.core.grid import Grid
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import (ArraySource, FunctionSource,
                                    sharded_stream_front, stream_front)
    smi = nvidia_smi_line()
    g = Grid.of(256, 256, 256)
    isabel = fields[("isabel", g.dims)]
    src = ArraySource(isabel.reshape(256, 256, 256))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = PersistencePipeline().diagram_stream(src, chunk_z=32)
    secs = time.perf_counter() - t0
    launches, plain = _read_counts(res.stream.n_chunks, "diagram_stream")
    peak = torch.cuda.max_memory_allocated()
    rep = res.stream
    crit = _check_result(res, g)
    same = res.to_bytes() == results[("isabel", g.dims, "fused")].to_bytes()
    log("stream", path="diagram_stream", field="isabel", dims=g.dims,
        seconds=round(secs, 3), critical=crit, launches=launches,
        plain_on_card=plain, peak_device_bytes=peak,
        payload_equals_in_memory=same, stages=_stage_line(res),
        report=_report_line(rep), smi=smi)
    if rep.n_chunks != 8 or not same:
        raise AssertionError(f"streamed isabel 256^3: {rep.n_chunks} "
                             f"chunks, payload equal: {same}")
    if rep.peak_resident_field_bytes > 2 * rep.max_chunk_bytes:
        raise AssertionError("more than two chunks of field resident")
    halo_launches = launches["fused_halo"]
    del res

    dims = (128, 128, 128)
    rf = fields[("random", dims)]
    _zero_counts()
    t0 = time.perf_counter()
    res = PersistencePipeline().run(TopoRequest(
        field=ArraySource(rf.reshape(128, 128, 128)), stream=True,
        chunk_z=16, n_blocks=4, distributed=False))
    secs = time.perf_counter() - t0
    launches, plain = _read_counts(res.stream.n_chunks, "sharded run")
    same = res.to_bytes() == results[("random", dims, "fused")].to_bytes()
    log("stream", path="sharded x4 run", field="random", dims=dims,
        seconds=round(secs, 3), launches=launches, plain_on_card=plain,
        payload_equals_in_memory=same, stages=_stage_line(res),
        report=_report_line(res.stream), smi=smi)
    if res.stream.n_shards != 4 or not same:
        raise AssertionError("sharded random 128^3 differs from in-memory")
    del res

    torch.cuda.empty_cache()
    one = stream_front(src, chunk_z=32)
    _zero_counts()
    t0 = time.perf_counter()
    four = sharded_stream_front(src, 4, chunk_z=32)
    secs = time.perf_counter() - t0
    launches, _ = _read_counts(four.report.n_chunks, "sharded front-end")
    _same_front(four, one, "sharded isabel 256^3 front-end")
    log("stream", path="sharded_stream_front x4", field="isabel",
        dims=g.dims, seconds=round(secs, 3), equals_stream_front=True,
        launches=launches, report=_report_line(four.report),
        single_shard=_report_line(one.report), smi=smi)
    del one, four
    torch.cuda.empty_cache()

    dims = (512, 512, 512)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = stream_front(FunctionSource.synthetic("random", dims, seed=SEED),
                       chunk_budget=64 << 20)
    secs = time.perf_counter() - t0
    launches, _ = _read_counts(out.report.n_chunks, "out-of-core front-end")
    chi = euler_characteristic(out.gf)
    log("stream", path="stream_front out of core", field="random",
        dims=dims, seconds=round(secs, 3), critical=out.gf.n_critical(),
        euler=chi, launches=launches,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        report=_report_line(out.report), smi=smi)
    if chi != 1:
        raise AssertionError(f"512^3 critical Euler characteristic {chi}")
    del out
    torch.cuda.empty_cache()
    return halo_launches


# budget of the dense bottleneck check: an (n x m) float64 distance matrix
# and a max-flow over up to n*m edges in Python (~2.5 s at 10^6 on a host
# core); a dimension whose n*m exceeds it is logged as skipped
GUARANTEE_BUDGET = 10 ** 6


def check_guarantee(res, exact, dims, what):
    """``bottleneck(res, exact) <= res.error_bound`` for each homology
    dimension whose pair counts fit GUARANTEE_BUDGET (essential classes
    always); returns ({dim: n x m checked}, {dim: n x m skipped})."""
    from repro_torch.approx import bottleneck_feasible, essential_distance
    bound = res.error_bound + 1e-9
    checked, skipped = {}, {}
    for p in range(len(dims)):
        a = res.pairs(p, min_persistence=0)
        b = exact.pairs(p, min_persistence=0)
        if essential_distance(res.essential(p), exact.essential(p)) > bound:
            raise AssertionError(f"{what}: essential classes of dim {p} "
                                 f"exceed the bound {bound}")
        nm = len(a) * len(b)
        if nm > GUARANTEE_BUDGET:
            skipped[p] = f"{len(a)}x{len(b)}"
            continue
        if not bottleneck_feasible(a, b, bound):
            raise AssertionError(f"{what}: dim {p} exceeds the bound {bound}")
        checked[p] = f"{len(a)}x{len(b)}"
    return checked, skipped


def time_block_minmax(f3, top, smi):
    """CUDA-event times of the level-1 ``block_minmax`` and of the cascade
    beside their byte bounds, and of ``max_pool3d`` (max and negated min)
    as the library call for the level-1 pass."""
    import torch
    import torch.nn.functional as F
    from repro_torch.approx import block_minmax
    from repro_torch.approx.hierarchy import cascade_minmax
    mn, mx = block_minmax(f3, 2)
    lib = lambda: (F.max_pool3d(f3[None, None], 2, 2, ceil_mode=True),
                   -F.max_pool3d(-f3[None, None], 2, 2, ceil_mode=True))
    lmx, lmn = lib()
    if not (torch.equal(lmx[0, 0], mx) and torch.equal(lmn[0, 0], mn)):
        raise AssertionError("max_pool3d disagrees with block_minmax")
    elt = f3.element_size()
    rec = {}
    for name, fn, nbytes in (
            ("block_minmax", lambda: block_minmax(f3, 2),
             f3.numel() * elt + 2 * mn.numel() * elt),
            ("cascade", lambda: cascade_minmax(mn, mx, top),
             sum(2 * mn.numel() * elt // 8 ** (l - 2)
                 + 2 * mn.numel() * elt // 8 ** (l - 1)
                 for l in range(2, top + 1)))):
        ms = cuda_ms(fn, reps=20)
        bms, by = bound_ms(dict(bytes=nbytes, ops=0))
        rec[name] = dict(ms=ms, bound_ms=bms, bound_by=by, bytes=nbytes)
    rec["block_minmax"]["library_ms"] = cuda_ms(lib, reps=20)
    for name, r in rec.items():
        log("approx", timing=name, dims=tuple(f3.shape), **r, smi=smi)


def phase_approx(fields, results, n=256):
    """Approximation on the card at ``isabel`` 256^3: the hierarchy
    (pyramid timed beside its bound; levels equal to the CPU's), every
    coarse level through ``approximate`` with its guarantee checked
    against the exact diagram of [main] as GUARANTEE_BUDGET allows, the
    full guarantee at 64^3 (``wavelet``), ``epsilon`` routing, ``refine`` with a
    deadline and to the end, and a ``MemmapSource`` at level 1 through
    the halo entry.  The launch counters are zeroed just before and read
    just after the approximation runs."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.approx import Hierarchy, approximate, refine
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.stream import MemmapSource
    smi = nvidia_smi_line()
    g = Grid.of(n, n, n)
    isabel = fields[("isabel", g.dims)]
    exact = results[("isabel", g.dims, "fused")]
    pipe = PersistencePipeline()
    req = TopoRequest(field=isabel, grid=g)

    f3 = torch.from_numpy(isabel).to(pipe.device).reshape(n, n, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = Hierarchy(f3, g, device=pipe.device)
    build_s = time.perf_counter() - t0
    h_cpu = Hierarchy(isabel, g)
    cpu_levels = [(lv.level, lv.stride, lv.dims, lv.bound)
                  for lv in h_cpu.levels]
    levels = [(lv.level, lv.stride, lv.dims, lv.bound) for lv in h.levels]
    log("approx", hierarchy="isabel", dims=g.dims, seconds=round(build_s, 4),
        levels=levels, equals_cpu=levels == cpu_levels, smi=smi)
    if levels != cpu_levels or h.max_level != n.bit_length() - 2:
        raise AssertionError(f"hierarchy on the card {levels} differs "
                             f"from the CPU's {cpu_levels}")
    time_block_minmax(f3, h.max_level, smi)

    _zero_counts()
    by_level = {}
    for lv in h.levels[1:]:
        t0 = time.perf_counter()
        res = approximate(pipe, req, level=lv.level, hierarchy=h)
        secs = time.perf_counter() - t0
        checked, skipped = check_guarantee(res, exact, g.dims,
                                           f"level {lv.level}")
        log("approx", level=lv.level, dims=lv.dims, bound=lv.bound,
            seconds=round(secs, 4),
            pairs={p: len(res.pairs(p, min_persistence=0))
                   for p in range(3)},
            d1_rounds=res.stats.get("d1_rounds"), guarantee_checked=checked,
            guarantee_skipped=skipped, stages=_stage_line(res))
        if (res.error_bound, res.approx_level, res.grid_dims) != \
                (lv.bound, lv.level, lv.dims):
            raise AssertionError(f"level {lv.level}: wrong guarantee stamp")
        by_level[lv.level] = res
    torch.cuda.synchronize()
    launches = dict(LS.LAUNCHES)
    plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    log("approx", levels_run=len(by_level), launches=launches,
        plain_on_card=plain)
    if launches["fused"] != len(by_level) or plain:
        raise AssertionError(f"approximation launches {launches}, plain "
                             f"{plain}: want the fused kernel once a level")

    # each level from 64^3 down, payload byte-equal to the same level on
    # the CPU (the plain version on the same decimated field)
    cpu_pipe = PersistencePipeline(device="cpu")
    for lv in h.levels[2:]:
        t0 = time.perf_counter()
        cpu = approximate(cpu_pipe, req, level=lv.level, hierarchy=h_cpu)
        same = cpu.to_bytes() == by_level[lv.level].to_bytes()
        log("approx", level=lv.level, dims=lv.dims, equals_cpu=same,
            cpu_seconds=round(time.perf_counter() - t0, 4))
        if not same:
            raise AssertionError(f"level {lv.level}: the card's payload "
                                 f"differs from the CPU's")

    # the whole guarantee at (n/4)^3, every level and every dimension, on the
    # smooth field whose pair counts fit the budget (isabel 64^3 has
    # 9980 / 25567 / 7121 pairs, too many for the dense check)
    q = n // 4
    f_q = make_field("wavelet", (q, q, q), seed=SEED)
    r_q = TopoRequest(field=f_q, grid=Grid.of(q, q, q))
    ex_q = pipe.run(r_q)
    for lv in Hierarchy(f_q, r_q.grid, device=pipe.device).levels[1:]:
        res = approximate(pipe, r_q, level=lv.level)
        checked, skipped = check_guarantee(res, ex_q, r_q.grid.dims,
                                           f"{q}^3 level {lv.level}")
        log("approx", full_check="wavelet", dims=r_q.grid.dims,
            level=lv.level, bound=lv.bound, guarantee_checked=checked,
            guarantee_skipped=skipped)
        if skipped:
            raise AssertionError(f"{q}^3 level {lv.level}: {skipped} did "
                                 f"not fit the budget")

    # epsilon picks the coarsest level that meets it
    eps = h.bound(3) + 1e-6
    want = h.pick_level(eps).level
    res = pipe.run(req.replace(epsilon=eps))
    log("approx", epsilon=eps, level=res.approx_level, expected=want)
    if res.approx_level != want or want != 3 or \
            res.to_bytes() != by_level[3].to_bytes():
        raise AssertionError(f"epsilon {eps} chose level "
                             f"{res.approx_level}, want {want}")

    # refine under a deadline: at least one result, bounds never grow
    t0 = time.perf_counter()
    walk = list(refine(pipe, req, deadline_s=0.5))
    bounds = [r.error_bound for r in walk]
    log("approx", refine="deadline_s=0.5", seconds=round(
        time.perf_counter() - t0, 4), levels=[r.approx_level for r in walk],
        bounds=bounds)
    if not walk or bounds != sorted(bounds, reverse=True):
        raise AssertionError(f"refine under a deadline gave {bounds}")

    # refine to the end at (n/2)^3 == run of the same progressive request
    f_h = make_field("isabel", (n // 2,) * 3, seed=SEED)
    r_h = TopoRequest(field=f_h, grid=Grid.of(n // 2, n // 2, n // 2))
    t0 = time.perf_counter()
    walk = list(refine(pipe, r_h))
    walk_s = time.perf_counter() - t0
    same = walk[-1].to_bytes() == pipe.run(
        r_h.replace(progressive=True)).to_bytes()
    log("approx", refine="to the end", field="isabel", dims=r_h.grid.dims,
        seconds=round(walk_s, 4), levels=[r.approx_level for r in walk],
        bounds=[r.error_bound for r in walk], equals_run=same)
    if not same or walk[-1].error_bound != 0.0:
        raise AssertionError("refine's last result differs from run")

    # out of core: a MemmapSource of the n^3 field at level 1
    with tempfile.TemporaryDirectory() as tmp:
        src = MemmapSource.write(os.path.join(tmp, "isabel.raw"),
                                 isabel.reshape(n, n, n))
        _zero_counts()
        t0 = time.perf_counter()
        res = approximate(pipe, TopoRequest(field=src, chunk_z=n // 4),
                          level=1)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(LS.LAUNCHES)
        plain = ref.CUDA_CALLS["lower_star_gradient_torch"]
    same = res.to_bytes() == by_level[1].to_bytes()
    log("approx", source="memmap", level=1, seconds=round(secs, 4),
        launches=launches, plain_on_card=plain, equals_in_memory=same,
        report=_report_line(res.stream), stages=_stage_line(res))
    if not same or launches["fused_halo"] != res.stream.n_chunks or plain:
        raise AssertionError("streamed level 1 differs or skipped the "
                             "halo entry")
    del f3, h, by_level
    torch.cuda.empty_cache()


def phase_serve(fields, n=256):
    """``TopoService`` on the card: four same-shape 64^3 fields from
    client threads in one batched dispatch (equal to ``run``), resubmitted
    as cache hits with no kernel launch, a progressive 256^3 submit with a
    deadline (preview first), a later ``epsilon`` submit served from the
    entry refinement stored, a ``wire=True`` payload, a traced request
    with one span per stage, and ``stats_payload``."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    from repro_torch.obs import validate_trace_events
    from repro_torch.pipeline import (DiagramResult, PersistencePipeline,
                                      TopoRequest)
    from repro_torch.serve import TopoService, stats_payload
    smi = nvidia_smi_line()
    dims = (n // 4,) * 3
    vols = [make_field(name, dims, seed=s).reshape(dims)
            for name, s in (("random", 1), ("wavelet", 2), ("magnetic", 3),
                            ("isabel", 4))]
    pipe = PersistencePipeline()
    want = [pipe.run(TopoRequest(field=v)).to_bytes() for v in vols]
    isabel = fields[("isabel", (n, n, n))].reshape(n, n, n)
    with TopoService(pipe, cache=True, max_batch=8, max_wait_s=0.5) as svc:
        futs = [None] * 4
        gate = threading.Barrier(4)

        def client(i):
            gate.wait()
            futs[i] = svc.submit(vols[i])

        _zero_counts()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        got = [f.result(timeout=300) for f in futs]
        batch_s = time.perf_counter() - t0
        launches = dict(LS.LAUNCHES)
        same = [r.to_bytes() == w for r, w in zip(got, want)]
        log("serve", batch=4, dims=dims, seconds=round(batch_s, 4),
            batches=svc.stats.batches, max_batch=svc.stats.max_batch,
            launches=launches, equals_run=same, smi=smi)
        if svc.stats.batches != 1 or launches["fused"] != 1 or not all(same):
            raise AssertionError("four same-shape submits were not served "
                                 "in one batched dispatch equal to run")

        _zero_counts()
        t0 = time.perf_counter()
        futs = [svc.submit(v) for v in vols]
        hits = [f.result(timeout=300) for f in futs]
        hit_s = time.perf_counter() - t0
        launches = dict(LS.LAUNCHES)
        same = [r.to_bytes() == w for r, w in zip(hits, want)]
        log("serve", resubmit=4, seconds=round(hit_s, 4),
            cache_hits=svc.stats.cache_hits, launches=launches,
            equals_run=same)
        if svc.stats.cache_hits != 4 or sum(launches.values()) or \
                not all(same):
            raise AssertionError("resubmits were not pure cache hits")

        _zero_counts()
        seen = {}
        t0 = time.perf_counter()
        fut = svc.submit(TopoRequest(field=isabel, deadline_s=1.0))
        # stamped where each future resolves (or at once if already done);
        # the preview's stamp records whether the final had resolved
        fut.preview.add_done_callback(lambda _: seen.setdefault(
            "preview", (time.perf_counter() - t0, fut.done())))
        fut.add_done_callback(lambda _: seen.setdefault(
            "final", (time.perf_counter() - t0, True)))
        preview = fut.preview.result(timeout=600)
        final = fut.result(timeout=600)
        (preview_s, final_first), (final_s, _) = seen["preview"], \
            seen["final"]
        top = n.bit_length() - 2
        levels = [r.approx_level for r in fut.partials]
        bounds = [r.error_bound for r in fut.partials]
        log("serve", progressive="isabel", dims=(n,) * 3, deadline_s=1.0,
            preview_s=round(preview_s, 4), final_s=round(final_s, 4),
            final_done_at_preview=final_first, levels=levels, bounds=bounds,
            launches=dict(LS.LAUNCHES),
            plain_on_card=ref.CUDA_CALLS["lower_star_gradient_torch"])
        if final_first or preview.approx_level != top \
                or fut.partials[0] is not preview \
                or fut.partials[-1] is not final \
                or (final.approx_level < top and len(levels) < 2) \
                or bounds != sorted(bounds, reverse=True) \
                or ref.CUDA_CALLS["lower_star_gradient_torch"]:
            raise AssertionError("progressive submit out of order")

        hits0 = svc.stats.cache_hits
        later = svc.submit(TopoRequest(field=isabel,
                                       epsilon=final.error_bound)) \
            .result(timeout=600)
        log("serve", epsilon=final.error_bound,
            served_from_cache=svc.stats.cache_hits == hits0 + 1,
            level=later.approx_level)
        if svc.stats.cache_hits != hits0 + 1 or \
                later.to_bytes() != final.to_bytes():
            raise AssertionError("the epsilon submit was not served from "
                                 "the refined entry")

        traced = svc.submit(TopoRequest(field=vols[0], trace=True)) \
            .result(timeout=300)
        doc = traced.trace.to_dict()
        validate_trace_events(doc)
        spans = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        log("serve", traced=True, spans=spans,
            equals_run=traced.to_bytes() == want[0])
        if spans != list(traced.plan.stage_names) or \
                traced.to_bytes() != want[0]:
            raise AssertionError(f"traced run spans {spans}")
        stats = json.loads(stats_payload(svc))
        log("serve", stats=json.dumps(stats, sort_keys=True))
    with TopoService(pipe, wire=True) as svc:
        blob = svc.submit(vols[1]).result(timeout=300)
    back = DiagramResult.from_bytes(blob)
    log("serve", wire=True, bytes=len(blob), decodes=back.betti())
    if blob != want[1]:
        raise AssertionError("wire payload differs from run's")


def phase_gradient(isabel_256):
    """The full discrete-vector-field check (``check_gradient_valid``:
    every valid simplex in exactly one role, pairs incident and inside one
    lower star, Euler characteristic 1) on the fused kernel's gradient of
    the main path's 256^3 field."""
    import torch
    from repro_torch.core.gradient import (check_gradient_valid,
                                           euler_characteristic,
                                           scatter_results_batch)
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import ops
    g = Grid.of(256, 256, 256)
    o = vertex_order(torch.from_numpy(isabel_256).cuda())
    [gf] = scatter_results_batch(g, *ops.lower_star_gradient(g, o))
    check_gradient_valid(g, gf, o)
    log("gradient", field="isabel", dims=g.dims, valid=True,
        euler=euler_characteristic(gf), critical=gf.n_critical())
    del gf, o
    torch.cuda.empty_cache()


def phase_cpu():
    import numpy as np
    from repro_torch.core.grid import Grid
    from repro_torch.fields.generators import make_field
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    for name, dims in (("wavelet", (32, 32, 32)), ("random", (32, 32, 32)),
                       ("random", (96, 2, 80))):
        f = make_field(name, dims, seed=SEED)
        req = TopoRequest(field=f, grid=Grid.of(*dims))
        gpu = PersistencePipeline().run(req)
        cpu = PersistencePipeline(device="cpu").run(req)
        for key, arr in cpu.arrays().items():
            if not np.array_equal(arr, gpu.arrays()[key], equal_nan=True):
                raise AssertionError(f"{name} {dims}: {key} differs")
        log("cpu", field=name, dims=dims, equal=True,
            pairs={p: len(cpu.pairs(p)) for p in cpu.homology_dims})


def phase_timing(isabel_256, report, plain=True):
    """CUDA-event times of both kernels on the [timing] fields, each beside
    its bound; ``report`` ([ptxas] phase) adds the launch shape, and
    ``plain`` times the plain version at 256^3 ``isabel``."""
    import torch
    from repro_torch.core.gradient import neighbor_orders
    from repro_torch.core.grid import Grid, vertex_order
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ref
    smi = nvidia_smi_line()
    records = {}
    g256 = Grid.of(256, 256, 256)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fields = {("isabel", 256): torch.from_numpy(isabel_256).cuda(),
              ("random", 256): torch.randn(g256.nv, generator=gen,
                                           device="cuda"),
              ("random", 512): torch.randn(512 ** 3, generator=gen,
                                           device="cuda")}
    shape = {k: {x: report[(k, "int32")][x] for x in
                 ("block", "registers", "stack_bytes", "static_smem",
                  "dynamic_smem", "blocks_per_sm")} if report else {}
             for k in ("fused", "prepass")}
    for (name, n), f in fields.items():
        g = Grid.of(n, n, n)
        o = vertex_order(f).to(torch.int32)
        del f
        out = LS.fused_lower_star_gradient(g, o)
        work = pairing_work(out[0], out[2])
        del out
        nb = neighbor_orders(g, o)
        runs = {"fused": (lambda: LS.fused_lower_star_gradient(g, o),
                          dict(work, bytes=io_bytes(g.nv, 4, False))),
                "prepass": (lambda: LS.lower_star_gradient_prepass(
                    nb, o, rank_bound=g.nv),
                    dict(work, bytes=io_bytes(g.nv, 4, True)))}
        for kernel, (fn, w) in runs.items():
            ms = cuda_ms(fn, reps=5)
            bms, by = bound_ms(w)
            log("timing", kernel=kernel, field=name, dims=(n, n, n), ms=ms,
                bound_ms=bms, bound_by=by, bytes=w["bytes"], ops=w["ops"],
                ops_v1=w["ops_v1"], ops_per_vertex=w["ops"] / g.nv,
                ops_v1_per_vertex=w["ops_v1"] / g.nv,
                pops_per_vertex=w["pops_per_vertex"],
                divergence=w["divergence"],
                divergence_regrouped=w["divergence_regrouped"],
                **shape[kernel], smi=smi)
            records[(kernel, name, n)] = dict(ms=ms, bound_ms=bms,
                                              bound_by=by)
        if plain and (name, n) == ("isabel", 256):
            plain_ms = cuda_ms(lambda: ref.lower_star_gradient_torch(
                nb, o, rank_bound=g.nv), reps=1)
            log("timing", kernel="plain", field=name, dims=(n, n, n),
                ms=plain_ms, smi=smi)
            records["plain_ms"] = plain_ms
        del nb, o, runs
        torch.cuda.empty_cache()
    if hasattr(LS, "fused_rows_from_halo_volume"):
        records["fused_halo"] = time_halo(isabel_256, plain, smi)
    return records


def time_halo(isabel_256, plain, smi):
    """CUDA-event times of the halo entry on every chunk of ``isabel``
    256^3 (int64 keys, ``chunk_z=32``), each beside its bound, and the
    totals over the grid (and the plain version's, if ``plain``)."""
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.kernels import lower_star as LS
    from repro_torch.kernels import ops
    from repro_torch.stream import pack_value_keys_torch, plan_chunks
    g = Grid.of(256, 256, 256)
    keys = pack_value_keys_torch(torch.from_numpy(isabel_256).cuda(), 0)
    plane = g.dims[0] * g.dims[1]
    tot = dict(ms=0.0, plain_ms=0.0 if plain else None, bytes=0, ops=0)
    for c in plan_chunks(g.dims, chunk_z=32):
        ext = _chunk_ext(keys, c, g.dims)
        out = LS.fused_rows_from_halo_volume(ext)
        work = pairing_work(out[0], out[2])
        del out
        work["bytes"] = io_bytes(c.nz * plane, 8, False, ghosts=2 * plane)
        ms = cuda_ms(lambda: LS.fused_rows_from_halo_volume(ext), reps=5)
        bms, by = bound_ms(work)
        pms = cuda_ms(lambda: ops.lower_star_rows_halo(ext, "torch"),
                      reps=1) if plain else None
        log("timing", kernel="fused_halo", field="isabel", dims=g.dims,
            chunk=(c.zlo, c.zhi), ms=ms, bound_ms=bms, bound_by=by,
            bytes=work["bytes"], ops=work["ops"], plain_ms=pms,
            pops_per_vertex=work["pops_per_vertex"],
            divergence_regrouped=work["divergence_regrouped"], smi=smi)
        tot["ms"] += ms
        tot["bytes"] += work["bytes"]
        tot["ops"] += work["ops"]
        if plain:
            tot["plain_ms"] += pms
        del ext
    tot["bound_ms"], tot["bound_by"] = bound_ms(tot)
    log("timing", kernel="fused_halo", field="isabel", dims=g.dims,
        chunks="all", **tot, smi=smi)
    del keys
    torch.cuda.empty_cache()
    return tot


def time_tree(root):
    """The [timing] phase alone, on the kernels of the port in ``root``
    (for instance another commit unpacked with ``git archive``)."""
    from repro_torch.fields.generators import make_field
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log("build", tree=root, seconds=round(time.perf_counter() - t0, 3))
    phase_timing(make_field("isabel", (256, 256, 256), seed=SEED), None,
                 plain=False)
    return 0


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description="On-card smoke test of the "
                                 "PyTorch / CUDA port.")
    ap.add_argument("--timing-of", metavar="DIR",
                    help="only time the kernels of the port in the tree DIR "
                    "([timing] fields, no plain version, no result lines); "
                    "to compare two trees, time each in turns in one call")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.timing_of or HERE)
    if not os.path.isdir(os.path.join(root, "src", "repro_torch")):
        print(f"chip_smoke.py: no src/repro_torch in {root}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    if args.timing_of:
        return time_tree(root)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    from repro_torch.fields.generators import make_field
    isabel = make_field("isabel", (256, 256, 256), seed=SEED)
    report = phase_build(smi)
    max_err = phase_kernels()
    halo_err = phase_halo_kernels(isabel)
    launches, fields, results = phase_main(isabel)
    phase_gradient(isabel)
    halo_launches = phase_stream(fields, results)
    phase_approx(fields, results)
    del results
    phase_serve(fields)
    phase_cpu()
    rec = phase_timing(isabel, report)
    kernels = []
    for key, src, line in (("fused", "fused.cu", 255),
                           ("prepass", "prepass.cu", 170)):
        r = rec[(key, "isabel", 256)]
        kernels.append({
            "name": f"{key}_lower_star", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/lower_star.py:{line}",
            "launches": launches[key], "max_abs_err": max_err,
            "ms": r["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    r = rec["fused_halo"]
    kernels.append({
        "name": "fused_lower_star_halo", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused.cu",
        "replaces": "src/repro/kernels/lower_star.py:325",
        "launches": halo_launches, "max_abs_err": halo_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None})
    log("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
