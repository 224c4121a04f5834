"""The PyTorch port's ``run_front`` over a ``GroupRing``: two processes,
one block each, joined by a gloo process group on the CPU.  Rank 0 writes
every case's outputs with ``torch.save``:

    python tests/torch_distributed_group.py OUT.pt

``test_torch_distributed.py`` holds them equal to the same calls over a
``LocalRing`` in one process.
"""

import os
import sys
import tempfile

WORLD = 2
# name -> (dims, seed, run_front keywords)
CASES = {
    "sort": ((6, 5, 16), 0, dict(gradient_backend="torch", sort_slack=4.0)),
    "rankfree": ((6, 5, 16), 3, dict(use_sample_sort=False)),
    "prepass": ((5, 4, 6), 2, dict(gradient_backend="prepass",
                                   sort_slack=4.0, overlap_comm=False)),
}
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def case_field(dims, seed):
    import numpy as np
    n = dims[0] * dims[1] * dims[2]
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _worker(rank, init, out):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    from repro_torch.distributed import GroupRing, run_front
    ring = GroupRing()
    res = {}
    for name, (dims, seed, kw) in CASES.items():
        _, o = run_front(dims, case_field(dims, seed), WORLD, ring=ring,
                         **kw)
        res[name] = {k: v.clone() for k, v in o.items()}
    if rank == 0:
        torch.save(res, out)
    dist.barrier()
    dist.destroy_process_group()


def main(out):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_worker, args=(init, out), nprocs=WORLD, join=True)
    print("WROTE", out)


if __name__ == "__main__":
    main(sys.argv[1])
