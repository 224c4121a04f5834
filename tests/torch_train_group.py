"""The PyTorch port's ``allreduce_compressed`` over a gloo process group:
two processes on the CPU, each compressing its own seeded gradient tree
(with a seeded residual) and all-reducing it.  Rank 0 writes what every
rank got, and the inputs, with ``torch.save``:

    python tests/torch_train_group.py OUT.pt

``test_torch_train.py`` holds the result equal to the mean of the ranks'
decompressed payloads, computed in one process.
"""

import os
import sys
import tempfile

WORLD = 2
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def rank_inputs(rank):
    """(gradient tree, residual tree) of ``rank``, seeded."""
    import numpy as np
    import torch
    rng = np.random.default_rng(100 + rank)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))
    g = {"a": t(5, 7), "b": {"c": t(3), "d": t(2, 3, 4)}}
    r = {"a": t(5, 7) * 0.01, "b": {"c": t(3) * 0.01, "d": t(2, 3, 4) * 0}}
    return g, r


def _worker(rank, init, out):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    from repro_torch.train.compression import allreduce_compressed
    g, r = rank_inputs(rank)
    summed, res = allreduce_compressed(g, r)
    got = [None] * WORLD
    dist.all_gather_object(got, {"summed": summed, "residual": res})
    if rank == 0:
        torch.save(got, out)
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
