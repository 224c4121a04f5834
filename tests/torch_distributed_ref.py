"""The JAX package's ``run_front`` on 4 forced host devices, for the
PyTorch port's array-for-array check (``test_torch_distributed.py``):

    python tests/torch_distributed_ref.py OUT.npz

Runs every case of ``CASES`` and writes each output array as
``<case>/<key>``.  The fused Pallas kernel does not build under the
installed jax, so the cases use the ``jax`` and ``pallas`` (prepass)
gradient backends only.
"""

import os
import sys

N_DEV = 4
# name -> (dims, seed or "ridge", run_front keywords of the reference)
CASES = {
    "a": ((6, 5, 16), 0, dict(gradient_backend="jax", sort_slack=4.0)),
    "b": ((6, 5, 16), 3, dict(gradient_backend="jax",
                              use_sample_sort=False)),
    "c": ((6, 5, 16), 3, dict(gradient_backend="pallas", sort_slack=4.0)),
    "d": ((5, 4, 24), 2, dict(gradient_backend="jax", sort_slack=4.0,
                              overlap_comm=False)),
    "e": ((3, 2, 16), "ridge", dict(gradient_backend="jax",
                                    use_sample_sort=False,
                                    ring_rotations=1)),
}


def ridge_field(dims, min_at_top):
    """Two descending ridges separated by a wall, joined by one saddle at
    the ridges' high end (``tests/shardmap_check.py``): D0 v-paths climb
    a ridge across every slab boundary."""
    import numpy as np
    nx, ny, nz = dims
    f = np.zeros((nz, ny, nx), np.float32)
    z = np.arange(nz, dtype=np.float32)
    s = z if min_at_top else (nz - 1 - z)
    for y in range(ny):
        f[:, y, 0] = -2.0 * s + 0.001 * y
        f[:, y, 2] = -2.0 * s + 0.5 + 0.001 * y
        f[:, y, 1] = 1000.0 + z + 0.001 * y
    f[0 if min_at_top else nz - 1, 0, 1] = 0.75
    return f.reshape(-1)


def case_field(dims, seed):
    import numpy as np
    if seed == "ridge":
        return ridge_field(dims, True)
    n = dims[0] * dims[1] * dims[2]
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def main(out):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={N_DEV} "
        + os.environ.get("XLA_FLAGS", ""))
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    import numpy as np
    import jax
    from repro.distributed.shardmap_pipeline import run_front
    assert jax.device_count() == N_DEV, jax.device_count()
    arrays = {}
    for name, (dims, seed, kw) in CASES.items():
        _, res = run_front(dims, case_field(dims, seed), N_DEV, **kw)
        arrays.update({f"{name}/{k}": v for k, v in res.items()})
    np.savez(out, **arrays)
    print("WROTE", len(arrays))


if __name__ == "__main__":
    main(sys.argv[1])
