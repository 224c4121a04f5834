"""Self-correcting distributed extremum-saddle pairing (paper Sec. IV-C,
Alg. 4), round-synchronous.

PyTorch counterpart of ``repro.distributed.pairing_rounds``.  The paper's
asynchronous protocol (optimistic pairings shipped across ranks, wrong
ones detected by saddle comparison and recomputed) is recast as the
fixpoint of a pure round function with its two ingredients:

  round(state):
    for every triplet (sigma, t0, t1) in parallel:
        r_i = age-filtered find of t_i  (follow rep links only while their
                                         assigning saddle is older)
        propose (die = younger of r0/r1, live = the older) if r0 != r1
    rebuild: per extremum the oldest proposing saddle wins; everything
             else is discarded (bulk correction).

The k oldest saddles' outcomes are exact after k rounds and never
regress, so the fixpoint equals the sequential Alg. 1.  The round is the
sandwich back-end's (``kernels.sandwich._d0_round``), run as torch ops
on the graph's device; this loop adds the statistics the distributed
engine reports: proposals, and corrections (pairings overturned by a
later round).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.extremum_graph import ExtremumGraph
from repro_torch.core.pairing import ExtremaPairs
from repro_torch.kernels.sandwich import (_d0_round, _extrema_pairs,
                                          _fixpoint_init, _no_pairs)
from repro_torch.obs import watchdog as _watchdog
from repro_torch.obs.metrics import global_metrics
from repro_torch.obs.trace import current_trace, maybe_span


@dataclass
class RoundStats:
    rounds: int = 0
    proposals: int = 0
    corrections: int = 0  # proposals overturned in later rounds


def pairing_fixpoint(g: ExtremumGraph, collect_stats: bool = False
                     ) -> Tuple[ExtremaPairs, RoundStats]:
    """Fixpoint of the round function: the same pairs as the sequential
    ``pair_extrema_saddles``, and with ``collect_stats`` the reference's
    proposal and correction counts."""
    stats = RoundStats()
    if len(g.saddles) == 0:
        return _no_pairs(g), stats
    nodes, c0, c1, ne, skey, ekey, rep, repkey, pair = _fixpoint_init(g)
    tr = current_trace()   # grabbed once: the loop runs on one thread
    while True:
        stats.rounds += 1
        _watchdog.progress("pairing.d0")    # round heartbeat
        with maybe_span(tr, "d0_round", round=stats.rounds):
            new_rep, new_repkey, new_pair, prop, _ = _d0_round(
                c0, c1, skey, ekey, rep, repkey)
            if collect_stats:
                stats.proposals += int(prop.sum())
                stats.corrections += int(((new_pair != pair)
                                          & (pair >= 0)).sum())
        if torch.equal(new_rep, rep) and torch.equal(new_pair, pair) \
                and torch.equal(new_repkey, repkey):
            break
        rep, repkey, pair = new_rep, new_repkey, new_pair
    global_metrics().counter("pairing.d0_rounds").inc(stats.rounds)
    return _extrema_pairs(g, nodes, pair, ne), stats
