"""Distributed persistence diagram across processes, one rank per card —
the PyTorch port's counterpart of ``examples/distributed_pd.py``: the
full DDMS pipeline through the ``PersistencePipeline`` facade (the
``shardmap`` z-slab front-end with its halo exchange over a
``torch.distributed`` process group, the self-correcting pairing rounds
and the token-based D1), checked against the sequential DMS run and
across ranks.  With ``--stream`` rank 0 also computes the diagram out of
core from a memmap file (``diagram_stream``, one process).

    torchrun --standalone --nproc-per-node=4 examples/distributed_pd_torch.py \
        [--dims 8 8 32] [--field isabel] [--stream]
    torchrun --standalone --nproc-per-node=2 examples/distributed_pd_torch.py \
        --device cpu                                  # gloo on the CPU

One z-slab block per rank, as the reference puts one on each device
(NCCL on ``cuda:LOCAL_RANK``, or gloo on the CPU); nz must divide by the
number of ranks.
"""
import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.diagram import same_offdiagonal  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.fields import make_field  # noqa: E402
from repro_torch.pipeline import PersistencePipeline, TopoRequest  # noqa: E402
from repro_torch.stream import MemmapSource  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", nargs="+", type=int, default=[8, 8, 32])
    ap.add_argument("--field", default="isabel")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: NCCL, one card per rank; cpu: gloo")
    ap.add_argument("--stream", action="store_true",
                    help="also compute out-of-core from a memmap file")
    ap.add_argument("--chunk-z", type=int, default=8,
                    help="owned z-planes per streamed chunk")
    return ap.parse_args(argv)


def stream_demo(args, g: Grid, f: np.ndarray, ref, device) -> None:
    """Out-of-core diagram from a raw float32 file, vs the in-memory run."""
    nx, ny, nz = g.dims
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "field.f32")
        src = MemmapSource.write(path, f.reshape(nz, ny, nx))
        res = PersistencePipeline(device=device).diagram_stream(
            src, chunk_z=args.chunk_z)
        sr = res.stream
        print(f"streamed from {path}: {sr.n_chunks} chunks of "
              f"{sr.chunk_z} planes, peak resident field bytes "
              f"{sr.peak_resident_field_bytes} (field is {f.nbytes})")
        ok = same_offdiagonal(res.diagram, ref.diagram)
        print(f"streamed == in-memory: {ok}")
        assert ok


def main(argv=None):
    args = parse(argv)
    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl")
    else:
        device = torch.device("cpu")
        dist.init_process_group("gloo")
    try:
        run(args, device)
    finally:
        dist.destroy_process_group()


def run(args, device):
    rank, world = dist.get_rank(), dist.get_world_size()
    n_blocks = world
    g = Grid.of(*args.dims)
    f = make_field(args.field, g.dims, seed=0)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"ranks={world} n_blocks={n_blocks} field={args.field} "
        f"dims={g.dims} device={device}")

    # distributed front + back ends vs the sequential reference, both
    # through the declarative front door
    ddms = PersistencePipeline(backend="shardmap", n_blocks=n_blocks,
                               distributed=True, device=device)
    req = TopoRequest(field=f, grid=g)
    say(ddms.lower(req).describe())
    res = ddms.run(req)
    ref = PersistencePipeline(device=device, distributed=False).run(
        TopoRequest(field=f, grid=g))
    ok = same_offdiagonal(res.diagram, ref.diagram)
    payloads = [None] * world
    dist.all_gather_object(payloads, res.to_bytes())
    same = all(p == payloads[0] for p in payloads)
    say(f"front-end over {world} ranks: criticals = "
        f"{res.stats.get('n_critical')}")
    say(f"DDMS == DMS: {ok}; every rank's payload equal: {same}")
    say("self-correcting pairing rounds:", res.stats.get("d0_rounds"),
        "corrections:", res.stats.get("d0_corrections"))
    say("D1 rounds:", res.stats.get("d1_rounds"), "token hops:",
        res.stats.get("d1_token_hops"), "steals:",
        res.stats.get("d1_steals"))
    assert ok and same

    if args.stream and rank == 0:
        stream_demo(args, g, f, ref, device)
    dist.barrier()


if __name__ == "__main__":
    main()
