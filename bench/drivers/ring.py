"""Driver of ``run_front`` traffic: the distributed front-end over a
process group of ``ranks`` processes, one per card (NCCL; gloo on the
CPU, for the tests), every rank making the call on the same field.

The harness's process is rank 0; the others are spawned here and joined
before the run returns.  Rendezvous goes through a file in a fresh
directory under the temporary directory the run is given.

Set-up: every rank starts, joins the group and sends ``warmup_requests``
calls of the configuration's grid (negative indices: fields the window
never sees), which loads the kernels, builds the communicators and runs
the first sample sort; on the first call's outputs it also does what it
does once in the window for the check.  The window is a closed loop of one client:
rank 0 decides after each call whether another goes out (the window's
``seconds`` have not passed) and tells the others; a call is complete
when it has returned on every rank.  Request ``i`` takes the blob layout
``(i + seed) mod field_layouts``, and its noise from ``(seed, i)``.

Of one request, drawn from the seed among the first
``check.sample_among_first``, every rank digests the outputs and rank 0
keeps on the host what the check reads (``bench/checks/<check>.py``).
Once the window has closed, the ranks send rank 0 their digests, peaks
and (traced) device times and leave the group; rank 0 then makes the
field again and the plain reference judges what it kept.

With ``--trace 1`` every rank runs the profiler over the window and
passes ``stats`` to ``run_front``, which then synchronizes at each
step's end; the step seconds are rank 0's.

A configuration's ``rank_hook`` (``"module:function"``, for the tests
that break the timed path underneath a run) is called with the rank in
every rank's process before anything else.
"""

from __future__ import annotations

import datetime
import importlib
import os
import random
import shutil
import sys
import tempfile
import time

from bench import devtrace, fields, found

TIMEOUT_S = 120
CALL = "run_front"


def _rank_run(rank, world, init, cell, seed, seconds, trace, device,
              t_start):
    """One rank's run; rank 0 returns the Outcome, the others None."""
    import torch
    import torch.distributed as dist

    t_start = time.perf_counter() if t_start is None else t_start
    split = {"imports_s": time.perf_counter() - t_start}
    cfg, mix = cell.config, cell.traffic
    if cfg.get("rank_hook"):
        mod, fn = cfg["rank_hook"].split(":")
        getattr(importlib.import_module(mod), fn)(rank)
    from repro_torch.distributed import run_front
    dims = tuple(int(d) for d in cfg["dims"])
    nv = dims[0] * dims[1] * dims[2]
    nb = int(cfg["n_blocks"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.empty(1, device=dev)
    else:
        dev = torch.device("cpu")
    split["cuda_s"] = time.perf_counter() - t_start
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    kw = dict(cfg.get("front", {}))
    layouts = int(mix["field_layouts"])
    check = found.load("checks", mix["check"]["reference"])

    def make(i):
        return fields.make(cfg["field"], dims, seed, i, (i + seed) % layouts,
                           dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def call(i, stats=None):
        f = make(i)
        _, out = run_front(dims, f, nb, stats=stats, **kw)
        sync()
        return out

    try:
        for w in range(int(mix.get("warmup_requests", 1))):
            out = call(-1 - w)
            # what the kept request does, once, outside the window
            check.digest(out)
            if rank == 0:
                check.program(out, dims, cfg, mix["check"], seed)
            del out
        dist.barrier()
        split["warmup_s"] = time.perf_counter() - t_start
        keep = random.Random(seed).randrange(
            int(mix["check"]["sample_among_first"]))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start

        prof = devtrace.profiler() if trace else None
        steps, marks, spans = [], [], []
        kept, kept_i, mine = None, -1, None
        go = torch.ones(1, dtype=torch.int64, device=dev)
        done = 0
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        with torch.profiler.record_function(devtrace.WINDOW):
            i = 0
            while True:
                marks.append(time.perf_counter())
                with torch.profiler.record_function(devtrace.REQUEST):
                    st = {} if trace else None
                    a = time.perf_counter()
                    out = call(i, st)
                    spans.append((CALL, a, time.perf_counter()))
                if st is not None:
                    steps.append(st.get("steps", {}))
                if i == keep:
                    mine = check.digest(out)
                    if rank == 0:
                        kept, kept_i = check.program(
                            out, dims, cfg, mix["check"], seed), i
                del out
                done += 1
                i += 1
                if rank == 0:
                    go.fill_(int(i <= keep
                                 or time.perf_counter() - t0 < seconds))
                dist.broadcast(go, 0)
                if not int(go.item()):
                    break
            sync()
        t1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        dt = devtrace.reduce(prof, marks, spans) if prof is not None \
            else None
        report = {"peak": int(peak), "digests": mine,
                  "busy_s": dt["busy_s"] if dt else None,
                  "window_s": dt["window_s"] if dt else None}
        reports = [None] * world
        dist.all_gather_object(reports, report)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return None

    from bench.harness import Outcome
    peak = max(r["peak"] for r in reports)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": world,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        busy = [r["busy_s"] for r in reports if r["busy_s"] is not None]
        wins = [r["window_s"] for r in reports if r["window_s"] is not None]
        device_info["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        device_info["window_s"] = sum(wins) / len(wins) if wins else t1 - t0
        if dt:
            breakdown = {"device_ops": dt["device_ops"],
                         "idle_gaps": dt["idle_gaps"]}
    split["setup_s"] = setup_s
    e2e = {"setup_s": setup_s, "ring_front_s": (t1 - t0) / done}
    if cuda:
        e2e["peak_B_per_vert"] = peak / (nv / world)
    ctx = {"kind": "ring", "steps": steps, "trace": dt, "nv": nv,
           "dims": dims, "config": cfg, "n_requests": done,
           "setup_split": split}
    print("setup split (s from the start): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()), file=sys.stderr)
    outcome_checks = {}
    if kept is not None:
        kept["digests"] = [r["digests"] for r in reports]
        if cuda:
            torch.cuda.empty_cache()
        field = make(kept_i)
        outcome_checks = check.compare(field, dims, kept)
        del field
    return Outcome(e2e=e2e, ctx=ctx, attempted=done, failed=0,
                   checks=outcome_checks, device=device_info,
                   breakdown=breakdown)


def _child(rank, world, init, cell, seed, seconds, trace, device, root):
    for p in (os.path.join(root, "src"), root):
        if p not in sys.path:
            sys.path.insert(0, p)
    _rank_run(rank, world, init, cell, seed, seconds, trace, device, None)


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start=None):
    import multiprocessing as mp
    from bench.harness import ROOT
    world = int(cell.config["ranks"])
    tmp = tempfile.mkdtemp(prefix="bench_ring_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(
        r, world, init, cell, seed, seconds, trace, device, ROOT))
        for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = _rank_run(0, world, init, cell, seed, seconds, trace, device,
                        t_start)
    finally:
        for p in procs:
            p.join(TIMEOUT_S)
            if p.is_alive():
                p.terminate()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks 1-{world - 1} exited with {bad}")
    return out
