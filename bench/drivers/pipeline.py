"""Driver of ``PersistencePipeline.run`` traffic: a closed loop of one
client, each request a fresh field of the configuration's grid, made on
the device from ``(seed, request index)``.

Set-up builds the pipeline and sends ``warmup_requests`` requests of the
same grid (negative indices: fields the window never sees), which loads
or builds the kernels and fills the plan cache and the allocator.  The
window then sends request after request until ``seconds`` have passed,
and closes when the last request returns.  A request is complete when
``run`` has returned it, and with it the pairs of its dimensions on the
host.

Request ``i`` takes the blob layout ``i mod field_layouts`` of a fixed
set, and noise of its own from ``(seed, i)``.  The layouts' order is the
same for every seed: the layouts cost differently, and a window that
cut their cycle at a place set by the seed made seeds differ by 4 %.

One request, drawn from the seed among the first
``check.sample_among_first``, is kept: its result, and the gradient field
its gradient stage made (read where the pipeline makes it, during that
request alone).  Once the window has closed and the peak has been read,
its field is made again and the plain reference checks what the program
returned for it.
"""

from __future__ import annotations

import random
import sys
import time

from bench import devtrace, fields, found


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start=None):
    import torch
    from repro_torch.core.grid import Grid
    from repro_torch.pipeline import PersistencePipeline, TopoRequest
    from repro_torch.pipeline import api
    from bench.harness import Outcome

    cfg, mix = cell.config, cell.traffic
    if mix.get("loop") != "closed" or int(mix.get("clients", 0)) != 1:
        raise ValueError(f"{mix['name']}: this driver sends a closed loop "
                         f"of one client")
    t_start = time.perf_counter() if t_start is None else t_start
    dims = tuple(int(d) for d in cfg["dims"])
    nv = dims[0] * dims[1] * dims[2]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    grid = Grid.of(*dims)
    hdims = tuple(mix["homology_dims"])
    layouts = int(mix["field_layouts"])

    def make(i):
        return fields.make(cfg["field"], dims, seed, i, i % layouts, dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    split = {"imports_s": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
    split["cuda_s"] = time.perf_counter() - t_start
    pipe = PersistencePipeline(cfg["backend"], sandwich_backend=cfg["sandwich"],
                               device=dev)
    for w in range(int(mix.get("warmup_requests", 1))):
        res = pipe.run(TopoRequest(field=make(-1 - w), grid=grid,
                                   homology_dims=hdims, trace=trace))
        del res
    sync()
    split["warmup_s"] = time.perf_counter() - t_start
    check = found.load("checks", mix["check"]["reference"])
    scatter = api.scatter_results_batch
    caught = []

    def catching(*a, **kw):
        gfs = scatter(*a, **kw)
        caught.append(gfs[0])
        return gfs
    keep = random.Random(seed).randrange(
        int(mix["check"]["sample_among_first"]))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    prof = devtrace.profiler() if trace else None
    stats, marks, spans = [], [], []
    kept, kept_i = None, -1
    attempted = failed = done = 0
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    with torch.profiler.record_function(devtrace.WINDOW):
        i = 0
        while i <= keep or time.perf_counter() - t0 < seconds:
            attempted += 1
            marks.append(time.perf_counter())
            with torch.profiler.record_function(devtrace.REQUEST):
                if i == keep:
                    api.scatter_results_batch = catching
                try:
                    res = pipe.run(TopoRequest(field=make(i), grid=grid,
                                               homology_dims=hdims,
                                               trace=trace))
                except Exception as exc:          # counted, and the loop goes on
                    failed += 1
                    caught.clear()
                    print(f"request {i} failed: {exc!r}", flush=True,
                          file=sys.stderr)
                    i += 1
                    continue
                finally:
                    api.scatter_results_batch = scatter
            done += 1
            stats.append(res.stats)
            if res.trace is not None:
                ep = res.trace.epoch
                spans.extend((s.name, ep + s.ts, ep + s.ts + s.dur)
                             for s in res.trace.events())
            if i == keep:
                kept, kept_i = check.program(
                    res, caught.pop() if caught else None), i
            del res
            i += 1
        sync()
    t1 = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    dt = devtrace.reduce(prof, marks, spans) if prof is not None else None
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        device_info["busy_s"] = dt["busy_s"] if dt else 0.0
        device_info["window_s"] = dt["window_s"] if dt else t1 - t0
        if dt:
            breakdown = {"device_ops": dt["device_ops"],
                         "idle_gaps": dt["idle_gaps"]}
    split["setup_s"] = setup_s
    e2e = {"setup_s": setup_s}
    if done:
        e2e["diagram_s"] = (t1 - t0) / done
    if cuda:
        e2e["peak_B_per_vert"] = peak / nv
    ctx = {"kind": "pipeline", "stats": stats, "trace": dt, "nv": nv,
           "dims": dims, "config": cfg, "n_requests": done,
           "setup_split": split}

    del pipe
    print("setup split (s from the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()), file=sys.stderr)
    outcome_checks = {}
    if kept is not None:
        field = make(kept_i)
        if cuda:
            torch.cuda.empty_cache()
        outcome_checks = check.compare(field, dims, kept)
        del field
    return Outcome(e2e=e2e, ctx=ctx, attempted=attempted, failed=failed,
                   checks=outcome_checks, device=device_info,
                   breakdown=breakdown)
