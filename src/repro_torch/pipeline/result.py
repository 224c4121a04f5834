"""`DiagramResult` — a queryable, serializable persistence-diagram result.

PyTorch counterpart of ``repro.pipeline.result``.  The result keeps the
live :class:`~repro_torch.core.diagram.Diagram` (device tensors), the
:class:`StageReport` and, for streamed runs, the
:class:`~repro_torch.stream.StreamReport`; it answers queries from small
canonical numpy arrays built once when the pipeline finishes (critical
simplices only), so a kept result does not pin the field or the dense
arrays: ``pairs(dim, min_persistence=…, top_k=…, space=…)``,
``essential(dim)``, ``betti()`` and ``arrays()`` — the same names and
contents as the reference's.

It serializes to the **DDMS v1 wire format** (``to_bytes`` /
``from_bytes``), byte for byte the reference's: a fixed header (magic
``DDMS``, version, grid dims) followed by dtype-tagged named arrays, so a
payload written by either package decodes in the other.

Approximate results (:mod:`repro_torch.approx`) carry one optional named
array, ``approx_meta`` = ``[error bound, level, stride, fine nx, ny,
nz]`` (float64), still wire version 1; decoded payloads answer
``error_bound`` / ``approx_level`` / ``pairs(certain_only=True)`` like
live results.

Wire format v1 (all little-endian)::

    header:  magic  b"DDMS" | version u16 | grid_ndim u8 | flags u8
             dims 3 x u64   | n_arrays u32
    array:   name_len u16 | name utf-8
             dtype_len u8 | numpy dtype.str ascii (e.g. "<i8", "<f4")
             ndim u8 | shape ndim x u64 | nbytes u64 | raw C-order data

Arrays are written in sorted name order.  Per computed homology
dimension ``p`` they are ``d{p}.pairs_sids`` (n, 2) simplex ids,
``d{p}.pairs_orders`` (n, 2) vertex orders, ``d{p}.pairs_values`` (n, 2)
field values, and the ``essential_*`` triple of the same; plus
``grid_dims``, ``homology_dims`` and ``query_defaults`` (min_persistence,
top_k; nan / -1 when unset).  Unknown (future-version) arrays are kept by
``from_bytes``, so the format can grow without breaking old readers.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.diagram import Diagram
from repro_torch.obs.trace import Trace
from repro_torch.stream.scheduler import StreamReport

from .plan import Plan
from .request import TopoRequest
from .stages import StageReport


WIRE_MAGIC = b"DDMS"
WIRE_VERSION = 1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@dataclass
class DiagramResult:
    """Diagram + stage report + queries over canonical arrays + wire
    serialization.  ``diagram`` is None for results decoded from the
    wire; queries still work off the decoded arrays."""

    diagram: Optional[Diagram]
    stats: Dict[str, float] = field(default_factory=dict)
    report: Optional[StageReport] = None
    stream: Optional[StreamReport] = None
    request: Optional[TopoRequest] = None
    plan: Optional[Plan] = None
    # span timeline of a trace=True run (live results only, not on the
    # wire); export with ``trace.to_perfetto(path)``
    trace: Optional[Trace] = field(default=None, repr=False, compare=False)
    _arrays: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)
    # vertex ids (tensor) -> field values (tensor); None once built
    _values_fn: Optional[Callable] = field(default=None, repr=False)

    @property
    def grid_dims(self) -> Tuple[int, ...]:
        if self.diagram is not None:
            return self.diagram.grid.dims
        return tuple(int(d) for d in self._arrays["grid_dims"])

    @property
    def homology_dims(self) -> Tuple[int, ...]:
        """Homology dimensions this result computed."""
        if "homology_dims" in self._arrays:
            return tuple(int(d) for d in self._arrays["homology_dims"])
        if self.plan is not None and self.plan.homology_dims:
            return self.plan.homology_dims
        return tuple(range(self.diagram.grid.dim + 1))

    # -- approximation guarantee (repro_torch.approx) ------------------------

    def _meta(self, i: int):
        meta = self._arrays.get("approx_meta")
        return None if meta is None else meta[i]

    @property
    def error_bound(self) -> Optional[float]:
        """Guaranteed bottleneck-distance bound to the exact diagram
        (field units); None for results the approximation engine never
        touched, 0.0 for a level-0 (exact) result."""
        b = self._meta(0)
        return None if b is None else float(b)

    @property
    def approx_level(self) -> Optional[int]:
        """Hierarchy level of this result (0 = exact)."""
        lev = self._meta(1)
        return None if lev is None else int(lev)

    @property
    def approx_stride(self) -> Optional[int]:
        """Decimation stride of the level (``2 ** approx_level``)."""
        s = self._meta(2)
        return None if s is None else int(s)

    @property
    def uncertainty_threshold(self) -> Optional[float]:
        """``2 * error_bound``: pairs whose value-space persistence is not
        strictly above it may be diagonal artifacts of the approximation."""
        b = self.error_bound
        return None if b is None else 2.0 * b

    def _build_arrays(self) -> None:
        """Canonical per-dimension arrays from the live diagram, sorted by
        (birth order, death order)."""
        dg, vf, req = self.diagram, self._values_fn, self.request
        if dg is None:
            raise ValueError("no diagram and no decoded arrays")
        order = dg.order
        out: Dict[str, np.ndarray] = {
            "grid_dims": np.asarray(dg.grid.dims, dtype=np.int64),
            "homology_dims": np.asarray(self.homology_dims, dtype=np.int64),
            "query_defaults": np.asarray(
                [np.nan if req is None or req.min_persistence is None
                 else req.min_persistence,
                 -1 if req is None or req.top_k is None else req.top_k],
                dtype=np.float64),
        }
        for p in self.homology_dims:
            pr = dg.pairs.get(p)
            if pr is None or len(pr) == 0:
                sids = np.zeros((0, 2), np.int64)
                ords = np.zeros((0, 2), np.int64)
                vals = np.zeros((0, 2), np.float64)
            else:
                bv, dv = dg.pair_max_vertices(p)
                ob, od = order[bv].long(), order[dv].long()
                idx = torch.argsort(od, stable=True)
                idx = idx[torch.argsort(ob[idx], stable=True)]
                sids = _np(pr.long()[idx])
                ords = _np(torch.stack([ob, od], dim=1)[idx])
                vals = (_np(torch.stack([vf(bv), vf(dv)], dim=1)[idx])
                        if vf is not None else None)
            out[f"d{p}.pairs_sids"] = sids
            out[f"d{p}.pairs_orders"] = ords
            if vals is not None:
                out[f"d{p}.pairs_values"] = vals
            es = dg.essential.get(p)
            if es is not None and len(es):
                ev = dg.essential_max_vertices(p)
                eo = order[ev].long()
                idx = torch.argsort(eo, stable=True)
                evals = _np(vf(ev)[idx]) if vf is not None else None
                es, eo = _np(es.long()[idx]), _np(eo[idx])
            else:
                es = np.zeros(0, np.int64)
                eo = np.zeros(0, np.int64)
                evals = np.zeros(0, np.float64) if vf is not None else None
            out[f"d{p}.essential_sids"] = es
            out[f"d{p}.essential_orders"] = eo
            if evals is not None:
                out[f"d{p}.essential_values"] = evals
        out.update(self._arrays)  # never clobber decoded arrays
        self._arrays = out

    def arrays(self) -> Dict[str, np.ndarray]:
        """The canonical named arrays (built on first use)."""
        if "grid_dims" not in self._arrays:
            self._build_arrays()
        return self._arrays

    def _dim_arrays(self, dim: int, kind: str, space: str) -> np.ndarray:
        if space not in ("value", "order"):
            raise ValueError(f"space must be 'value' or 'order', got {space!r}")
        if dim not in self.homology_dims:
            raise ValueError(
                f"dimension {dim} was not computed (homology_dims="
                f"{self.homology_dims})")
        key = f"d{dim}.{kind}_{'values' if space == 'value' else 'orders'}"
        arrs = self.arrays()
        if key not in arrs:
            raise ValueError("no field values attached to this result; "
                             "query with space='order' instead")
        return arrs[key]

    def _default_queries(self) -> tuple:
        """(min_persistence, top_k) defaults: from the originating
        request, or from the decoded ``query_defaults`` wire array."""
        if self.request is not None:
            return self.request.min_persistence, self.request.top_k
        qd = self._arrays.get("query_defaults")
        if qd is None:
            return None, None
        mp = None if np.isnan(qd[0]) else float(qd[0])
        tk = None if qd[1] < 0 else int(qd[1])
        return mp, tk

    def pairs(self, dim: int = 0, *, min_persistence: Optional[float] = None,
              top_k: Optional[int] = None, space: str = "value",
              certain_only: bool = False) -> np.ndarray:
        """(n, 2) (birth, death) points of dimension ``dim``, sorted by
        descending persistence (ties by birth).  ``min_persistence`` keeps
        ``death - birth >=`` the threshold, ``top_k`` the k most
        persistent; defaults come from the request, or from the decoded
        ``query_defaults`` wire array (the value-space ``min_persistence``
        is not applied to order-space queries).  ``certain_only`` (value
        space only) also drops the pairs of an approximate result whose
        persistence is not strictly above its ``uncertainty_threshold``."""
        certain_thr = None
        if certain_only:
            if space != "value":
                raise ValueError(
                    "certain_only applies to value-space queries (the "
                    "error bound is in field units)")
            certain_thr = self.uncertainty_threshold
        d_mp, d_tk = self._default_queries()
        if min_persistence is None and space == "value":
            min_persistence = d_mp
        if top_k is None:
            top_k = d_tk
        pts = self._dim_arrays(dim, "pairs", space)
        pers = pts[:, 1] - pts[:, 0]
        if min_persistence is not None and min_persistence > 0:
            keep = pers >= min_persistence
            pts, pers = pts[keep], pers[keep]
        if certain_thr is not None and certain_thr > 0:
            keep = pers > certain_thr
            pts, pers = pts[keep], pers[keep]
        idx = np.argsort(-pers, kind="stable")
        if top_k is not None:
            idx = idx[:top_k]
        return pts[idx]

    def essential(self, dim: int = 0, *, space: str = "value") -> np.ndarray:
        """(n,) birth coordinates of the infinite classes of ``dim``."""
        return self._dim_arrays(dim, "essential", space)

    def betti(self) -> Dict[int, int]:
        """Betti numbers = essential-class counts per computed dim."""
        arrs = self.arrays()
        return {p: len(arrs[f"d{p}.essential_sids"])
                for p in self.homology_dims}

    # -- wire format ---------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Serialize to the versioned DDMS wire format (see module doc)."""
        arrs = self.arrays()
        dims = self.grid_dims
        parts = [WIRE_MAGIC,
                 struct.pack("<HBB", WIRE_VERSION, len(dims), 0),
                 struct.pack("<3Q", *dims),
                 struct.pack("<I", len(arrs))]
        for name in sorted(arrs):
            a = np.ascontiguousarray(arrs[name])
            nb = name.encode("utf-8")
            ds = a.dtype.str.encode("ascii")
            parts.append(struct.pack("<H", len(nb)) + nb)
            parts.append(struct.pack("<B", len(ds)) + ds)
            parts.append(struct.pack("<B", a.ndim)
                         + struct.pack(f"<{a.ndim}Q", *a.shape))
            parts.append(struct.pack("<Q", a.nbytes))
            parts.append(a.tobytes())
        return b"".join(parts)

    @classmethod
    def from_bytes(cls, payload: bytes) -> "DiagramResult":
        """Decode a wire payload into a queryable result (no live
        Diagram; ``pairs``/``essential``/``betti`` work off the arrays)."""
        buf = memoryview(payload)
        if bytes(buf[:4]) != WIRE_MAGIC:
            raise ValueError(
                f"not a DDMS payload (magic {bytes(buf[:4])!r})")
        version, _ndim, _flags = struct.unpack_from("<HBB", buf, 4)
        if version > WIRE_VERSION:
            raise ValueError(
                f"wire version {version} is newer than supported "
                f"({WIRE_VERSION})")
        dims = struct.unpack_from("<3Q", buf, 8)
        (n_arrays,) = struct.unpack_from("<I", buf, 32)
        off = 36
        arrs: Dict[str, np.ndarray] = {}
        for _ in range(n_arrays):
            (nlen,) = struct.unpack_from("<H", buf, off)
            off += 2
            name = bytes(buf[off:off + nlen]).decode("utf-8")
            off += nlen
            (dlen,) = struct.unpack_from("<B", buf, off)
            off += 1
            dtype = np.dtype(bytes(buf[off:off + dlen]).decode("ascii"))
            off += dlen
            (andim,) = struct.unpack_from("<B", buf, off)
            off += 1
            shape = struct.unpack_from(f"<{andim}Q", buf, off)
            off += 8 * andim
            (nbytes,) = struct.unpack_from("<Q", buf, off)
            off += 8
            a = np.frombuffer(buf[off:off + nbytes], dtype=dtype)
            arrs[name] = a.reshape(shape).copy()
            off += nbytes
        if off != len(payload):
            raise ValueError(
                f"trailing bytes in payload ({len(payload) - off})")
        arrs.setdefault("grid_dims", np.asarray(dims, dtype=np.int64))
        return cls(diagram=None, _arrays=arrs)
