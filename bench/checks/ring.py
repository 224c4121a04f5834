"""The check of the distributed front-end, ``run_front`` over a process
group, one rank per card.

``run_front`` gathers every block's outputs onto every rank.  Of the
request kept, every rank digests each output (:func:`digest`), and rank 0
keeps on the host what the reference judges (:func:`program`): the
vertex ranks, each vertex's own row (``vstat``, ``vpart``), the critical
simplices its 74 packed rows hold (counted at each vertex), the packed
rows of a sample of vertices drawn from the seed, the D0 and dual triplet
buffers' valid rows, and the counts.  The numbers compared:

- ``rank_mismatch``: vertices whose rank is not the reference's;
- ``vertex_row_mismatch``: vertices whose ``vstat`` or ``vpart`` is not
  the reference's (critical at a minimum, else paired with the edge to
  its lowest neighbour);
- ``critical_count_mismatch``: over every vertex, the critical edges,
  triangles and tets of its rows, and the dual buffer's critical
  triangles, against the lower link's (summed differences); the totals
  (``ncrit``) and the fullest block's count (``crit_peak``) too;
- ``critical_edge_mismatch``: critical edges (vertex, row) in the D0
  buffer and not the reference's, or the reverse;
- ``d0_triplet_mismatch``: D0 rows whose key (the two vertices' ranks)
  or ends (the minima the steepest descents from the two vertices reach)
  differ;
- ``dual_key_mismatch``: dual rows whose key (the vertex's rank, then
  the other two vertices' ranks, highest first) differs;
- ``packed_row_mismatch``: of the sampled vertices, rows (74 status, 74
  partner, and the vertex's own) that differ from a plain
  ProcessLowerStars of the vertex;
- ``dual_triplet_mismatch``: of a sample of the dual rows drawn from the
  seed, those whose triangle is not critical in the plain pairing of its
  vertex, or whose ends (the critical tet, or OMEGA, that the ascending
  dual paths from the triangle's two tets reach) differ;
- ``rank_digest_mismatch``: ranks whose digest of any output differs
  from rank 0's;
- ``unresolved``: the program's own count of chains left unresolved,
  plus 1 if its sample sort overflowed.

Every limit is 0: the configuration states an exact result.
"""

from __future__ import annotations

import random
from typing import Dict

import torch

from bench import reference as R
from bench.fields import request_seed

LIMITS = {"rank_mismatch": 0, "vertex_row_mismatch": 0,
          "critical_count_mismatch": 0, "critical_edge_mismatch": 0,
          "d0_triplet_mismatch": 0, "dual_key_mismatch": 0,
          "packed_row_mismatch": 0, "dual_triplet_mismatch": 0,
          "rank_digest_mismatch": 0, "unresolved": 0}

_MASK = (1 << 64) - 1
_D0 = ("sid_v", "row", "key", "t0", "t1")


def digest(out: Dict[str, torch.Tensor]) -> list:
    """One 64-bit number per output of ``run_front`` (in key order): the
    sum of the output's bytes, read as 64-bit words, each times an odd
    number drawn from its position.  Computed where the outputs lie, in
    chunks."""
    res = []
    for k in sorted(out):
        b = out[k].contiguous().reshape(-1).view(torch.uint8)
        n8 = b.numel() // 8 * 8
        parts = [b[:n8].view(torch.int64), b[n8:].long()]
        h = torch.zeros((), dtype=torch.int64, device=b.device)
        at = 0
        for w in parts:
            for a in range(0, w.numel(), 1 << 25):
                c = w[a:a + (1 << 25)]
                m = torch.arange(at + a, at + a + c.numel(), device=b.device,
                                 dtype=torch.int64)
                m = (m * 0x2545F4914F6CDD1D + 0x632BE59BD9B4E019) | 1
                h += (c * m).sum()
            at += w.numel()
        res.append(int(h) & _MASK)
    return res


def _sample(n: int, size: int, seed: int) -> torch.Tensor:
    """Up to ``size`` distinct vertex ids, drawn from the seed."""
    if size >= n:
        return torch.arange(n)
    gen = torch.Generator().manual_seed(request_seed(seed, 0x5A3) >> 1)
    return torch.unique(torch.randint(n, (size,), generator=gen))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in page-locked host memory (from the host
    allocator's cache once a same-sized copy has been made and freed)."""
    if t.device.type == "cpu":
        return t.clone()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _rows_of(buf: dict) -> dict:
    return {k: _host(buf[k]) for k in _D0}


def program(out: Dict[str, torch.Tensor], dims, cfg: dict, check_cfg: dict,
            seed: int) -> dict:
    """What the check keeps of rank 0's outputs, on the host, for the
    configuration ``cfg``.  The copies go to page-locked memory: the
    driver runs this once on a set-up call's outputs too, so that inside
    the window the host allocator hands out memory it already holds."""
    n = out["ranks"].numel()
    st = out["status"].reshape(n, R.NROWS)
    counts = torch.empty((n, 3), dtype=torch.int8, device=st.device)
    step = 1 << 22
    for a in range(0, n, step):
        c = st[a:a + step] == R.CRIT
        counts[a:a + step] = torch.stack(
            [c[:, :14].sum(1), c[:, 14:50].sum(1), c[:, 50:].sum(1)],
            1).to(torch.int8)
        del c
    counts = _host(counts)
    verts = _sample(n, int(check_cfg["sample_vertices"]), seed)
    vd = verts.to(st.device)
    kept = {"n_blocks": int(cfg["n_blocks"]), "seed": seed,
            "sample_dual": int(check_cfg["sample_dual"]),
            "ranks": _host(out["ranks"]), "vstat": _host(out["vstat"]),
            "vpart": _host(out["vpart"]), "counts": counts, "sample": verts,
            "status": _host(st[vd]),
            "partner": _host(out["partner"].reshape(n, R.NROWS)[vd])}
    for name in ("d0", "dual"):
        ok = out[f"{name}_valid"].bool()
        kept[name] = _rows_of({"sid_v": out[f"{name}_sid_v"][ok],
                               "row": out[f"{name}_row"][ok],
                               "key": out[f"{name}_key"][ok],
                               "t0": out[f"{name}_t0"][ok],
                               "t1": out[f"{name}_t1"][ok]})
    kept.update(ncrit=out["ncrit"].tolist(),
                crit_peak=int(out["crit_peak"]),
                unresolved=int(out["unresolved"]),
                overflow=bool(out["overflow"]), digests=[])
    return kept


def compare(field: torch.Tensor, dims, kept: dict) -> Dict[str, tuple]:
    fr = R.front_reference(field, dims)
    dev = fr.rank.device
    n = fr.rank.numel()
    nx, ny, _ = dims
    got = {}
    ranks = kept["ranks"].to(dev).reshape(-1).long()
    got["rank_mismatch"] = int((ranks != fr.rank).sum()) if len(ranks) == n \
        else n
    del ranks
    minimum = fr.mask == 0
    vstat = torch.where(minimum, R.CRIT, R.TAIL)
    vpart = torch.where(minimum, -1, R.edge_row(fr.low.long()))
    got["vertex_row_mismatch"] = int(
        ((kept["vstat"].to(dev).long() != vstat)
         | (kept["vpart"].to(dev).long() != vpart)).sum())
    del vstat, vpart

    # critical cells at every vertex, and the totals
    d0, dual = ({k: v.to(dev).long() for k, v in kept[b].items()}
                for b in ("d0", "dual"))
    want = fr.crit.long()
    miss = int((kept["counts"].to(dev).long() - want).abs().sum())
    miss += int((torch.bincount(dual["sid_v"].clamp(0, n - 1), minlength=n)
                 - want[:, 1]).abs().sum())
    ref_n = fr.n_critical()
    miss += sum(abs(int(kept["ncrit"][k]) - ref_n[k]) for k in range(4))
    per_block = want[:, :2].reshape(kept["n_blocks"], -1, 2).sum(1)
    miss += abs(kept["crit_peak"] - int(per_block.max()))
    got["critical_count_mismatch"] = miss
    del want, per_block

    # the D0 buffer: its critical edges, keys and ends
    got["critical_edge_mismatch"] = R.set_difference(
        d0["sid_v"] * R.NROWS + d0["row"],
        fr.sv * R.NROWS + R.edge_row(fr.sj))
    off = R.row_offsets(dev)
    step = torch.tensor([1, nx, nx * ny], device=dev)

    def other(v, row, m):
        """The vid of the other vertex ``m`` of each row, -1 outside."""
        o = off[row.clamp(0, R.NROWS - 1), m]
        x = v % nx + o[:, 0]
        y = (v // nx) % ny + o[:, 1]
        z = v // (nx * ny) + o[:, 2]
        inside = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) \
            & (v >= 0) & (v < n)
        return torch.where(inside & (v + (o * step).sum(1) < n),
                           v + (o * step).sum(1), -1)

    v, u = d0["sid_v"], other(d0["sid_v"], d0["row"], 0)
    okv = (v >= 0) & (v < n) & (u >= 0)
    vc, uc = v.clamp(0, n - 1), u.clamp(0, n - 1)
    exp = torch.stack([fr.rank[vc], fr.rank[uc], fr.root[vc], fr.root[uc]],
                      1)
    have = torch.cat([d0["key"].reshape(-1, 2), d0["t0"][:, None],
                      d0["t1"][:, None]], 1)
    got["d0_triplet_mismatch"] = int(((have != exp).any(1) | ~okv).sum())

    # the dual buffer's keys, all of them
    v = dual["sid_v"]
    o1, o2 = other(v, dual["row"], 0), other(v, dual["row"], 1)
    okv = (v >= 0) & (v < n) & (o1 >= 0) & (o2 >= 0) & (dual["row"] >= 14) \
        & (dual["row"] < 50)
    r1, r2 = fr.rank[o1.clamp(0, n - 1)], fr.rank[o2.clamp(0, n - 1)]
    exp = torch.stack([fr.rank[v.clamp(0, n - 1)], torch.maximum(r1, r2),
                       torch.minimum(r1, r2)], 1)
    got["dual_key_mismatch"] = int(
        ((dual["key"].reshape(-1, 3) != exp).any(1) | ~okv).sum())
    del o1, o2, r1, r2, exp, have, okv

    # single vertices against the plain ProcessLowerStars
    stars = R.Stars(fr.rank.cpu().numpy(), dims)
    del fr
    bad = 0
    kstat, kpart = kept["status"].cpu().long(), kept["partner"].cpu().long()
    vstat, vpart = kept["vstat"].cpu().long(), kept["vpart"].cpu().long()
    for i, v in enumerate(kept["sample"].tolist()):
        status, partner, vs, vp = stars.pairing(v)
        bad += int((kstat[i] != torch.tensor(status)).sum())
        bad += int((kpart[i] != torch.tensor(partner)).sum())
        bad += int(int(vstat[v]) != vs) + int(int(vpart[v]) != vp)
    got["packed_row_mismatch"] = bad

    rows = len(dual["sid_v"])
    pick = random.Random(request_seed(kept["seed"], 0xD0A1)).sample(
        range(rows), min(rows, kept["sample_dual"]))
    bad = 0
    sv, rw = dual["sid_v"].cpu(), dual["row"].cpu()
    t0, t1 = dual["t0"].cpu(), dual["t1"].cpu()
    for i in pick:
        v, row = int(sv[i]), int(rw[i])
        if not (0 <= v < n and 14 <= row < 50) \
                or stars.pairing(v)[0][row] != R.CRIT:
            bad += 1
            continue
        cof = stars.triangle_cofacets(v, row)
        ends = [stars.ascend(c) for c in cof] + [R.OMEGA] * (2 - len(cof))
        bad += int(ends != [int(t0[i]), int(t1[i])])
    got["dual_triplet_mismatch"] = bad

    digests = kept["digests"]
    got["rank_digest_mismatch"] = sum(int(d != digests[0]) for d in digests)
    got["unresolved"] = int(kept["unresolved"]) + int(kept["overflow"])
    return {k: (v, LIMITS[k]) for k, v in got.items()}


def control(field: torch.Tensor, dims, cfg: dict, check_cfg: dict,
            seed: int, dtype=torch.bfloat16) -> dict:
    """The reference on the field rounded to ``dtype``, in the form that
    ``program`` keeps: its dual buffer holds the critical triangles of the
    sampled vertices."""
    fr = R.front_reference(field.to(dtype).float(), dims)
    n = fr.rank.numel()
    minimum = fr.mask == 0
    u = fr.sv + R._offsets(dims, fr.rank.device)[fr.sj]
    stars = R.Stars(fr.rank.cpu().numpy(), dims)
    verts = _sample(n, int(check_cfg["sample_vertices"]), seed)
    pairings = [stars.pairing(v) for v in verts.tolist()]
    dual = {k: [] for k in _D0}
    for v, (status, _, _, _) in zip(verts.tolist(), pairings):
        for row in range(14, 50):
            if status[row] != R.CRIT:
                continue
            cof = stars.triangle_cofacets(v, row)
            ends = [stars.ascend(c) for c in cof] + [R.OMEGA] * (2 - len(cof))
            oth = [stars._vid(v, o) for o in R.ROWS[row][3]]
            rk = sorted((int(stars.rank[w]) for w in oth), reverse=True)
            for k, x in zip(_D0, (v, row, [int(stars.rank[v])] + rk,
                                  ends[0], ends[1])):
                dual[k].append(x)
    nb = int(cfg["n_blocks"])
    per_block = fr.crit[:, :2].long().reshape(nb, -1, 2).sum(1)
    return {"n_blocks": nb, "seed": seed,
            "sample_dual": int(check_cfg["sample_dual"]), "ranks": fr.rank,
            "vstat": torch.where(minimum, R.CRIT, R.TAIL),
            "vpart": torch.where(minimum, -1, R.edge_row(fr.low.long())),
            "counts": fr.crit, "sample": verts,
            "status": torch.tensor([p[0] for p in pairings]),
            "partner": torch.tensor([p[1] for p in pairings]),
            "d0": {"sid_v": fr.sv, "row": R.edge_row(fr.sj),
                   "key": torch.stack([fr.rank[fr.sv], fr.rank[u]], 1),
                   "t0": fr.root[fr.sv], "t1": fr.root[u]},
            "dual": {k: torch.tensor(v, dtype=torch.int64)
                     for k, v in dual.items()},
            "ncrit": [fr.n_critical()[k] for k in range(4)],
            "crit_peak": int(per_block.max()), "unresolved": 0,
            "overflow": False, "digests": [0]}
