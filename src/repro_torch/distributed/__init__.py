"""Distributed DDMS building blocks (PyTorch counterpart of
``repro.distributed``): the block ring (``comm``; ``block_ring`` picks
the process group's or a local one), the distributed sample
sort (``order``), the halo-exchanged front-end with ring resolution
(``shardmap_pipeline``), the self-correcting extremum-saddle pairing
rounds (``pairing_rounds``) and the token-based D1 rounds
(``d1_rounds``)."""

from .comm import GroupRing, LocalRing, Ring, block_ring  # noqa: F401
from .shardmap_pipeline import (CritCapacityError, FrontConfig,  # noqa: F401
                                front_triplets, run_front)
