"""`DiagramCache` — epsilon-aware, byte-budgeted LRU of diagram payloads.

The port's own copy of ``repro.cache.store`` (host code).  Values are the
versioned ``DiagramResult.to_bytes`` wire payloads: opaque bytes the
service can ship straight to a ``wire=True`` client or decode with
``DiagramResult.from_bytes`` — the cache never
holds live ``Diagram`` objects, so entries cost exactly their payload
size and survive any amount of churn bit-exactly.

The lookup rule is the Vidal–Tierny approximation guarantee turned
into a cache-reuse predicate: every entry is stamped with the
``error_bound`` its result carries (``0.0`` for exact results), and
``get(key, epsilon)`` returns the entry iff ``error_bound <=
epsilon``.  An exact entry therefore serves *every* request on its key
— including approximate ones, for free — while a level-l approximate
entry serves any request whose budget is at least its bound.

``put`` only ever **tightens**: a payload with a strictly smaller
bound replaces the stored one in place (progressive refinement walks a
field coarse-to-fine, upgrading its entry level by level until it is
exact); an equal-or-looser payload is dropped.  So the cache is
monotone — serving can only get more accurate over time, never less.

Thread-safe (one lock around the LRU book-keeping; payloads are
immutable bytes) and byte-budgeted: inserts evict least-recently-used
entries until the total payload size fits ``max_bytes``; a payload
larger than the whole budget is rejected outright rather than flushing
the cache for one entry.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class CacheEntry:
    """One cached result: wire payload + its approximation guarantee."""

    payload: bytes
    error_bound: float = 0.0     # guaranteed d_B bound; 0.0 = exact
    level: int = 0               # hierarchy level the payload came from
    hits: int = 0                # lookups this entry served
    upgrades: int = 0            # in-place tightenings it received

    @property
    def nbytes(self) -> int:
        return len(self.payload)

    @property
    def exact(self) -> bool:
        return self.error_bound <= 0.0


class DiagramCache:
    """Epsilon-aware LRU over ``DiagramResult`` wire payloads.

    Parameters
    ----------
    max_bytes : total payload budget; least-recently-used entries are
        evicted to make room (entry metadata is not counted — payloads
        dominate by orders of magnitude).
    """

    def __init__(self, max_bytes: int = 256 << 20):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[tuple, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self._bytes = 0
        # counters (read under the lock by stats())
        self.hits = 0            # get() served a qualifying entry
        self.misses = 0          # get() found nothing usable
        self.bound_misses = 0    # ... the key existed but its bound > eps
        self.insertions = 0
        self.upgrades = 0        # tighter payload replaced an entry
        self.rejected = 0        # equal-or-looser put dropped
        self.evictions = 0

    # -- lookup ------------------------------------------------------------

    def get(self, key: tuple, epsilon: float = 0.0) -> Optional[CacheEntry]:
        """The entry for ``key`` iff its ``error_bound <= epsilon``.

        ``epsilon=0.0`` (an exact request) is served only by exact
        entries; any positive budget is additionally served by
        approximate entries at least that tight.  A qualifying lookup
        touches LRU recency; a bound miss does not (the entry earned no
        reuse)."""
        if not epsilon >= 0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                return None
            if ent.error_bound > epsilon:
                self.misses += 1
                self.bound_misses += 1
                return None
            self.hits += 1
            ent.hits += 1
            self._entries.move_to_end(key)
            return ent

    def peek(self, key: tuple) -> Optional[CacheEntry]:
        """The entry regardless of bound; no LRU touch, no counters."""
        with self._lock:
            return self._entries.get(key)

    # -- admission ---------------------------------------------------------

    def put(self, key: tuple, payload: bytes, *, error_bound: float = 0.0,
            level: int = 0) -> bool:
        """Admit ``payload`` under ``key``; returns True if stored.

        A new key inserts (evicting LRU entries to fit the byte
        budget); an existing key is **upgraded in place** only when the
        new bound is strictly tighter — the cache monotonically
        tightens, so a coarse recompute can never clobber a refined
        entry.  Payloads larger than the whole budget are rejected."""
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            raise TypeError(
                f"payload must be bytes (a DiagramResult wire payload), "
                f"got {type(payload).__name__}")
        payload = bytes(payload)
        error_bound = float(error_bound)
        if not error_bound >= 0:
            raise ValueError(
                f"error_bound must be >= 0, got {error_bound}")
        if len(payload) > self.max_bytes:
            with self._lock:
                self.rejected += 1
            return False
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                if error_bound >= ent.error_bound:
                    self.rejected += 1      # not tighter: keep what we have
                    return False
                self._bytes -= ent.nbytes
                ent.payload = payload
                ent.error_bound = error_bound
                ent.level = int(level)
                ent.upgrades += 1
                self._bytes += ent.nbytes
                self.upgrades += 1
                self._entries.move_to_end(key)
            else:
                self._entries[key] = CacheEntry(
                    payload, error_bound=error_bound, level=int(level))
                self._bytes += len(payload)
                self.insertions += 1
            while self._bytes > self.max_bytes:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self.evictions += 1
        return True

    # -- book-keeping ------------------------------------------------------

    @property
    def bytes(self) -> int:
        """Total resident payload bytes."""
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._entries

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def stats(self) -> Dict[str, int]:
        """Plain-dict counter snapshot (a copy, never a view)."""
        with self._lock:
            return dict(size=len(self._entries), bytes=self._bytes,
                        max_bytes=self.max_bytes, hits=self.hits,
                        misses=self.misses, bound_misses=self.bound_misses,
                        insertions=self.insertions, upgrades=self.upgrades,
                        rejected=self.rejected, evictions=self.evictions)
