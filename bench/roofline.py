"""The yardstick's hardware model and byte and operation counts.

Peaks of one NVIDIA H100 SXM from NVIDIA's data sheet (dense rates, no
sparsity, at its full 700 W power limit; the benchmark prints the card's
own limit beside its numbers): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
outside the tensor cores, integer work at half of that (an SM issues
int32 on 64 of its 128 lanes), 989 TFLOP/s in bf16.

The byte count of one lower-star pairing launch is the one the port's
planner uses (each input read once, each output written once: the rank
of every vertex, then 74 status and 74 partner bytes, a vstat byte and a
4-byte vpart a vertex).  Its operation count keeps only the part every
vertex needs whatever its data (14 compares that find the lower
neighbours and 36 + 2 x 24 ANDs that decide which triangle and tet rows
lie in the lower star); the data-dependent rest (the sort of each
lower-star row's key and one operation per row still open at each pop)
is left out, so the count is low, and the bound it gives can only be
low.  At 512^3 the bytes bind with room to spare either way.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT_OPS_PER_S = F32_FLOPS / 2
BF16_FLOPS = 989e12

ROW_BYTES = 74 + 74 + 1 + 4          # status, partner, vstat, vpart
FIXED_OPS_PER_VERTEX = 14 + 36 + 48


def io_bytes(n: int, rank_bytes: int, prepass: bool = False,
             ghosts: int = 0) -> int:
    """Bytes a pairing launch over ``n`` vertices must move."""
    return (n * rank_bytes * (28 if prepass else 1) + ghosts * rank_bytes
            + n * ROW_BYTES)


def pairing_ops(n: int) -> int:
    """The integer operations every vertex of a launch needs."""
    return FIXED_OPS_PER_VERTEX * n


def bound_s(nbytes: float, ops: float):
    """The least time for the work, and which bound it is."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / INT_OPS_PER_S
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def rank_bytes(n: int) -> int:
    """The width of a vertex rank on a grid of ``n`` vertices: the port
    passes int32 ranks below 2^31 vertices, int64 from there."""
    return 4 if n < 2 ** 31 else 8


def fused_launch_bound_s(n: int):
    """The least time of one fused-kernel launch over a whole grid."""
    return bound_s(io_bytes(n, rank_bytes(n)), pairing_ops(n))
