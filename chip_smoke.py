#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # from the repository root, one GPU
    python3 chip_smoke.py --timing-of DIR  # phase 5 alone, on DIR's kernels

Phases (one line each; any failing phase makes the script exit non-zero):

1. build    — both CUDA kernels with nvcc from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, started together); prints the
              build seconds, ptxas' registers / stack / spills of each of
              the four instantiations, the launch shape, shared memory and
              resident blocks per SM the runtime reports, and
              ``nvidia-smi --query-gpu=name,power.limit``.
2. kernels  — the fused and prepass kernels bit-equal to the plain PyTorch
              version on the card (tolerance 0: all outputs are integers)
              over asymmetric, thin, 2-D and 1-D grids, int32 and int64
              ranks, 127^3 (packed-key grid) and 128^3 (first column-key
              grid), a batch of 3, 256^3, and the edges of the kernels'
              128-vertex tiles: dims that are no multiple of it, nx = ny =
              1, batches of 3 whose tiles cross a member's end, and int64
              ranks above 2^31.
3. main     — the main path: ``PersistencePipeline().run`` on ``isabel``
              256^3 and ``random`` 128^3 through the ``fused`` kernel, and
              the ``prepass`` backend on ``random`` 128^3 as its
              cross-check, plus ``run_batch`` of 3 same-shape fields.  The
              launch counters are zeroed just before and read just after;
              both kernels must have launched and the plain version must
              not have run on the card.  Gradient check: the critical
              counts have Euler characteristic 1 and match the diagram;
              then ``check_gradient_valid`` on the 256^3 gradient.
4. cpu      — diagrams on the card equal those on the CPU (32^3 wavelet,
              32^3 random, a thin 2-D grid).
5. timing   — CUDA-event times of ``fused`` and ``prepass`` at 256^3
              (``isabel``, ``random``) and 512^3 (``random``) and of the
              plain version at 256^3, each beside its bound (the longer of
              its bytes over 3.35 TB/s and the integer operations the
              pairing needs on this run's data over 33.5 T/s), the pops
              per vertex and the warp divergence factor of that data.

The line before the last is the JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script prints no result and exits non-zero.

``--timing-of DIR`` runs only phase 5 (without the plain version) on the
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

def io_bytes(n, rank_bytes, prepass):
    """Bytes a pairing launch must move: each input read once (ranks,
    plus the (n, 27) tensor for the prepass kernel), each output written
    once (74 + 74 + 1 + 4 B/vertex)."""
    return n * rank_bytes * (28 if prepass else 1) + n * (74 + 74 + 1 + 4)


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
    """{ranks: {registers, stack, spill_stores, spill_loads}} of each
    kernel instantiation in one source's ``ptxas -v`` log."""
    import re
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = "int32" if "IiE" in m.group(1) else "int64"
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
        for ranks, r in ptxas_report(v["log"]).items():
            dtype = torch.int32 if ranks == "int32" else torch.int64
            r.update(LS.kernel_attrs(name, dtype))
            report[(name, ranks)] = r
            log("ptxas", kernel=name, ranks=ranks, **r)
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
             ((129, 1, 1), 3, i64, big)]
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


def phase_main():
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
    fields = {(n, d): make_field(n, d, seed=SEED) for n, d, _ in runs}
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
    return launches, fields[("isabel", (256, 256, 256))]


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
    return records


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
    report = phase_build(smi)
    max_err = phase_kernels()
    launches, isabel = phase_main()
    phase_gradient(isabel)
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
    log("done", seconds=round(time.perf_counter() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
