"""Content-addressed cache keys for fields and diagram requests.

PyTorch counterpart of ``repro.cache.fingerprint``.  A request is served
from a stored result only when both describe the same answer:

- :func:`fingerprint_field` — the field's content identity.  numpy
  arrays digest their bytes (sha256 over dtype + shape + data); a torch
  tensor is digested as the numpy array of its host copy, so its key
  equals the reference's key for the same data; sources answer through
  their own ``fingerprint()`` (:mod:`repro_torch.stream.chunks`), or
  raise :class:`CacheKeyError`, the explicit opt-out.
- :func:`request_key` — the fingerprint with every result-affecting knob
  (grid dims, defaulted homology dims, ``min_persistence``, ``top_k``).
  Execution knobs (backend, device, streaming, chunking) are excluded:
  their diagrams are bit-identical.  ``epsilon`` is excluded too: it is
  a lookup-time predicate on a stored entry's ``error_bound``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# the one CacheKeyError, defined beside the sources that raise it
from repro_torch.stream.chunks import CacheKeyError  # noqa: F401

#: bump when the key schema changes so stale persisted keys never alias
KEY_SCHEMA = 1


def fingerprint_array(a) -> str:
    """sha256 content digest of an array (dtype + shape + bytes); a torch
    tensor is digested as its host copy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(a.dtype.str.encode("ascii"))
    h.update(repr(a.shape).encode("ascii"))
    h.update(a.tobytes())
    return f"array:{h.hexdigest()}"


def fingerprint_field(field) -> str:
    """Stable content identity of a request's field payload.

    Arrays and tensors digest their bytes; sources answer through
    ``fingerprint()``.  Raises :class:`CacheKeyError` for stripped
    requests (``field=None``) and sources without a fingerprint."""
    if field is None:
        raise CacheKeyError(
            "request carries no field payload (stripped record?)")
    if isinstance(field, (np.ndarray, torch.Tensor)):
        return fingerprint_array(field)
    fp = getattr(field, "fingerprint", None)
    if fp is not None:
        out = fp()   # may itself raise CacheKeyError (anonymous fn, ...)
        if not isinstance(out, str) or not out:
            raise CacheKeyError(
                f"{type(field).__name__}.fingerprint() returned "
                f"{out!r}, want a non-empty str")
        return out
    if hasattr(field, "read_slab") and hasattr(field, "dims"):
        raise CacheKeyError(
            f"source {type(field).__name__} has no fingerprint() "
            f"method; implement one (see repro_torch.stream.FieldSource) "
            f"or submit with cache=False")
    return fingerprint_array(np.asarray(field))


def request_key(request) -> tuple:
    """The canonical cache key of a :class:`TopoRequest`: ``(schema,
    field fingerprint, grid dims, homology dims, min_persistence,
    top_k)``, taken after ``resolve()`` so two spellings of one request
    share it.  Raises :class:`CacheKeyError` when the field cannot be
    fingerprinted."""
    req = request.resolve()
    grid = req.grid
    hdims = req.homology_dims if req.homology_dims is not None \
        else tuple(range(grid.dim + 1))
    mp = None if req.min_persistence is None else float(req.min_persistence)
    tk = None if req.top_k is None else int(req.top_k)
    return (KEY_SCHEMA, fingerprint_field(req.field), tuple(grid.dims),
            tuple(hdims), mp, tk)
