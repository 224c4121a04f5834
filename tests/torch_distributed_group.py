"""The PyTorch port's distributed front-end over a ``GroupRing``: WORLD
processes joined by a gloo process group on the CPU, each holding
BLOCKS consecutive blocks.  Every rank's results go to rank 0, which
writes them with ``torch.save`` as ``{"ranks": [rank 0's, rank 1's,
...]}``:

    python tests/torch_distributed_group.py OUT.pt [--world 2] \
        [--blocks 1] [--jobs front ring ref pipeline stats]

Jobs: ``ring`` applies every collective (:func:`ring_ops`) to this rank's
blocks of :func:`ring_inputs`; ``front`` runs ``CASES`` through
``run_front``; ``ref`` runs ``torch_distributed_ref.CASES`` (4 blocks);
``pipeline`` runs the ``shardmap`` pipeline on :func:`pipeline_field`
with ``distributed`` off and on, and records the errors of an
indivisible block count and of a device that is not the group's
(``block_ring``'s, a pipeline's, and ``run_front``'s on a field that
lies off the host with no ``device=``).
``stats`` runs the ``sort`` case through ``run_front`` with ``stats`` and
again without, with CUDA events, profiler ranges and flight-recorder
records made to fail in the second.
``test_torch_distributed.py`` holds them equal to the same calls over a
``LocalRing`` in one process, and to the JAX package.
"""

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 2
# name -> (dims, seed, run_front keywords)
CASES = {
    "sort": ((6, 5, 16), 0, dict(gradient_backend="torch", sort_slack=4.0)),
    "rankfree": ((6, 5, 16), 3, dict(use_sample_sort=False)),
    "prepass": ((5, 4, 6), 2, dict(gradient_backend="prepass",
                                   sort_slack=4.0, overlap_comm=False)),
}
# the reference's gradient backends -> the port's
BACKEND = {"jax": "torch", "pallas": "prepass", "fused": "fused"}
PIPELINE_DIMS = (6, 5, 8)


def case_field(dims, seed):
    import numpy as np
    n = dims[0] * dims[1] * dims[2]
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def pipeline_field():
    return case_field(PIPELINE_DIMS, 4)


def ring_inputs(n_blocks):
    """Global (n_blocks, ...) inputs of every collective: int64 with
    negatives, bool (gloo moves none), float32, and an (n_blocks,
    n_blocks, 2) all_to_all source."""
    import torch
    x = torch.arange(n_blocks * 6, dtype=torch.int64).reshape(
        n_blocks, 3, 2) * 7 - 5
    g = torch.Generator().manual_seed(n_blocks)
    return dict(x=x, m=x % 3 == 0,
                f=torch.randn(n_blocks, 4, generator=g),
                y=torch.arange(n_blocks * n_blocks * 2).reshape(
                    n_blocks, n_blocks, 2))


def ring_ops(ring, inp):
    """Every collective of ``ring`` on ``inp`` (this holder's blocks of
    :func:`ring_inputs`), by name; ``gather_blocks`` is (n_blocks, ...),
    every other result this holder's (Bl, ...)."""
    import torch
    out = {"blocks": ring.blocks()}
    for up in (True, False):
        for wrap in (False, True):
            for k in ("x", "m"):
                out[f"shift_{k}_{up}_{wrap}"] = ring.shift(inp[k], up, wrap)
            out[f"shift_async_f_{up}_{wrap}"] = ring.shift_async(
                inp["f"], up, wrap)()
    out["all_gather_x"] = ring.all_gather(inp["x"])
    out["all_gather_m"] = ring.all_gather(inp["m"])
    out["all_to_all_y"] = ring.all_to_all(inp["y"])
    out["psum_x32"] = ring.psum(inp["x"].to(torch.int32))
    out["psum_m"] = ring.psum(inp["m"])
    out["pmax_x"] = ring.pmax(inp["x"])
    out["pmax_m"] = ring.pmax(inp["m"])
    out["pmax_f"] = ring.pmax(inp["f"])
    out["gather_blocks_x"] = ring.gather_blocks(inp["x"])
    return {k: v.contiguous().clone() for k, v in out.items()}


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _worker(rank, init, out, world, blocks, jobs):
    sys.path.insert(0, SRC)
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.distributed import block_ring, run_front
    nb = world * blocks
    res = {}
    if "ring" in jobs:
        ring = block_ring(nb)
        mine = ring.blocks()
        res["ring"] = ring_ops(ring, {k: v[mine] for k, v in
                                      ring_inputs(nb).items()})
        res["ring_type"] = type(ring).__name__
    if "front" in jobs:
        for name, (dims, seed, kw) in CASES.items():
            _, o = run_front(dims, case_field(dims, seed), nb, **kw)
            res[name] = {k: v.clone() for k, v in o.items()}
    if "stats" in jobs:
        import repro_torch.obs.flight as flight
        dims, seed, kw = CASES["sort"]
        st = {}
        _, a = run_front(dims, case_field(dims, seed), nb, stats=st, **kw)

        def boom(*a, **k):
            raise RuntimeError("recorded without stats")
        saved = (torch.cuda.Event, torch.profiler.record_function,
                 flight.FlightRecorder.record)
        torch.cuda.Event = torch.profiler.record_function = boom
        flight.FlightRecorder.record = boom
        try:
            _, b = run_front(dims, case_field(dims, seed), nb, **kw)
        finally:
            (torch.cuda.Event, torch.profiler.record_function,
             flight.FlightRecorder.record) = saved
        res["stats_steps"] = dict(st["steps"])
        res["stats_same"] = set(a) == set(b) and all(
            torch.equal(a[k], b[k]) for k in a)
    if "ref" in jobs:
        import torch_distributed_ref as REF
        for name, (dims, seed, kw) in REF.CASES.items():
            kw = dict(kw, gradient_backend=BACKEND[kw["gradient_backend"]])
            _, o = run_front(dims, REF.case_field(dims, seed), nb, **kw)
            res["ref_" + name] = {k: v.clone() for k, v in o.items()}
    if "pipeline" in jobs:
        from repro_torch.core.grid import Grid
        from repro_torch.pipeline import PersistencePipeline, TopoRequest
        for d in (False, True):
            r = PersistencePipeline("shardmap", n_blocks=nb, distributed=d,
                                    device="cpu").run(TopoRequest(
                                        field=pipeline_field(),
                                        grid=Grid.of(*PIPELINE_DIMS)))
            res[f"payload_{d}"] = r.to_bytes()
            res[f"stats_{d}"] = dict(r.stats)
        # world + 1 blocks divide over no world >= 2
        bad = (4, 4, world + 1)
        res["indivisible"] = _error(lambda: block_ring(world + 1))
        res["indivisible_front"] = _error(lambda: run_front(
            bad, case_field(bad, 0), world + 1))
        res["wrong_device"] = _error(lambda: block_ring(nb, "meta"))
        dims = CASES["sort"][0]
        res["field_off_host"] = _error(lambda: run_front(
            dims, torch.from_numpy(case_field(dims, 0)).to("meta"), nb))
        res["wrong_device_pipeline"] = _error(lambda: PersistencePipeline(
            "shardmap", n_blocks=nb, device="meta").run(TopoRequest(
                field=pipeline_field(), grid=Grid.of(*PIPELINE_DIMS))))
    gathered = [None] * world if rank == 0 else None
    dist.gather_object(res, gathered, dst=0)
    if rank == 0:
        torch.save({"ranks": gathered}, out)
    dist.barrier()
    dist.destroy_process_group()


def main(argv):
    import torch.multiprocessing as mp
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--world", type=int, default=WORLD)
    ap.add_argument("--blocks", type=int, default=1,
                    help="blocks per rank")
    ap.add_argument("--jobs", nargs="+", default=["front"],
                    choices=["front", "ring", "ref", "pipeline",
                             "stats"])
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_worker, args=(init, args.out, args.world, args.blocks,
                                tuple(args.jobs)),
                 nprocs=args.world, join=True)
    print("WROTE", args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
