"""Bottleneck distance between persistence diagrams (L-infinity).

The port's own copy of ``repro.approx.metrics`` (host numpy; the port
imports nothing of the JAX package).  It is the machine-checkable half of
the approximation guarantee: the tests and ``chip_smoke.py`` check
``bottleneck(approx, exact) <= bound`` on the port's results.

A diagram here is an ``(n, 2)`` array of (birth, death) points.  The
bottleneck distance allows any point to be matched to the diagonal at
cost ``persistence / 2``, so diagrams of different cardinality compare
fine.  The decision problem ("is ``d_B <= d``?") reduces to a perfect
matching in the classical diagram-plus-diagonal bipartite graph
(Edelsbrunner & Harer); because the diagonal dummies are
interchangeable, the graph collapses to a unit-capacity flow network
with two *capacity* diagonal nodes, solved exactly by Dinic's
algorithm:

    s -> a (1, each A point)        a -> b (1, iff linf(a, b) <= d)
    s -> DL (|B|)                   a -> DR (1, iff pers(a)/2 <= d)
    DL -> b (1, iff pers(b)/2 <= d) DL -> DR (min(|A|, |B|))
    b -> t (1), DR -> t (|A|)       feasible iff maxflow == |A| + |B|

``bottleneck_feasible`` answers one decision (one maxflow — what the
guarantee tests call, with ``d`` = the level's bound);
``bottleneck_distance`` binary-searches the finite candidate set (all
pairwise L-inf distances plus all half-persistences) for the exact
optimum.  Note that points shared verbatim by both diagrams must NOT be
pre-cancelled: forcing a common point to match its twin at cost 0 can
steal a partner the optimal matching needs elsewhere, overestimating
the distance — the matching itself decides.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np


def _clean(pts) -> np.ndarray:
    """(n, 2) float64, off-diagonal points only (diagonal points match
    the diagonal at cost 0 and never affect the distance)."""
    p = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    if len(p) and (~np.isfinite(p)).any():
        raise ValueError("bottleneck distance needs finite points; "
                         "compare essential classes separately")
    return p[p[:, 0] != p[:, 1]]


class _Dinic:
    """Small dense-graph Dinic max-flow (unit-ish capacities)."""

    def __init__(self, n: int):
        self.n = n
        self.to: List[int] = []
        self.cap: List[int] = []
        self.adj: List[List[int]] = [[] for _ in range(n)]

    def edge(self, u: int, v: int, c: int) -> None:
        self.adj[u].append(len(self.to))
        self.to.append(v)
        self.cap.append(c)
        self.adj[v].append(len(self.to))
        self.to.append(u)
        self.cap.append(0)

    def _bfs(self, s: int, t: int) -> bool:
        self.level = [-1] * self.n
        self.level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for e in self.adj[u]:
                v = self.to[e]
                if self.cap[e] > 0 and self.level[v] < 0:
                    self.level[v] = self.level[u] + 1
                    q.append(v)
        return self.level[t] >= 0

    def _dfs(self, u: int, t: int, f: int, it: List[int]) -> int:
        # recursion depth is bounded by the layer count (<= 4 layers in
        # the diagram-matching network), never by the diagram size
        if u == t:
            return f
        while it[u] < len(self.adj[u]):
            e = self.adj[u][it[u]]
            v = self.to[e]
            if self.cap[e] > 0 and self.level[v] == self.level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[e]), it)
                if d:
                    self.cap[e] -= d
                    self.cap[e ^ 1] += d
                    return d
            it[u] += 1
        return 0

    def maxflow(self, s: int, t: int) -> int:
        flow = 0
        while self._bfs(s, t):
            it = [0] * self.n
            while True:
                f = self._dfs(s, t, 1 << 60, it)
                if not f:
                    break
                flow += f
        return flow


def bottleneck_feasible(a, b, d: float) -> bool:
    """Decision problem: is the bottleneck distance between finite
    diagrams ``a`` and ``b`` at most ``d``?  One max-flow."""
    a, b = _clean(a), _clean(b)
    n, m = len(a), len(b)
    if n == 0 and m == 0:
        return True
    pa = (a[:, 1] - a[:, 0]) / 2.0
    pb = (b[:, 1] - b[:, 0]) / 2.0
    if n == 0:
        return bool((pb <= d).all())
    if m == 0:
        return bool((pa <= d).all())
    # node ids: s, A points, B points, DL, DR, t
    S, A0, B0 = 0, 1, 1 + n
    DL, DR, T = 1 + n + m, 2 + n + m, 3 + n + m
    g = _Dinic(4 + n + m)
    dist = np.max(np.abs(a[:, None, :] - b[None, :, :]), axis=2)
    for i in range(n):
        g.edge(S, A0 + i, 1)
        if pa[i] <= d:
            g.edge(A0 + i, DR, 1)
        for j in np.nonzero(dist[i] <= d)[0]:
            g.edge(A0 + i, B0 + int(j), 1)
    for j in range(m):
        g.edge(B0 + j, T, 1)
        if pb[j] <= d:
            g.edge(DL, B0 + j, 1)
    g.edge(S, DL, m)
    g.edge(DL, DR, min(n, m))
    g.edge(DR, T, n)
    return g.maxflow(S, T) == n + m


def bottleneck_distance(a, b) -> float:
    """Exact bottleneck distance between two finite diagrams.

    Binary search over the finite candidate set (the optimum is always
    a pairwise L-inf distance or a half-persistence)."""
    a, b = _clean(a), _clean(b)
    n, m = len(a), len(b)
    if n == 0 and m == 0:
        return 0.0
    cands = [np.zeros(1)]
    cands.append((a[:, 1] - a[:, 0]) / 2.0)
    cands.append((b[:, 1] - b[:, 0]) / 2.0)
    if n and m:
        cands.append(np.max(np.abs(a[:, None, :] - b[None, :, :]),
                            axis=2).reshape(-1))
    c = np.unique(np.concatenate(cands))
    lo, hi = 0, len(c) - 1           # c[hi] (match everything) is feasible
    while lo < hi:
        mid = (lo + hi) // 2
        if bottleneck_feasible(a, b, float(c[mid])):
            hi = mid
        else:
            lo = mid + 1
    return float(c[lo])


def essential_distance(a, b) -> float:
    """Bottleneck distance between essential (infinite) classes: 1-D
    birth multisets, matchable only to each other — ``inf`` when the
    counts differ (an essential class cannot retire to the diagonal)."""
    a = np.sort(np.asarray(a, dtype=np.float64).reshape(-1))
    b = np.sort(np.asarray(b, dtype=np.float64).reshape(-1))
    if len(a) != len(b):
        return float("inf")
    if len(a) == 0:
        return 0.0
    return float(np.max(np.abs(a - b)))
