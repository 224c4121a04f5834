"""Epsilon-aware diagram cache and admission control (host side).

PyTorch counterpart of ``repro.cache``:

- :mod:`.fingerprint` — content-addressed keys (field fingerprint with
  the result-affecting request knobs; tensors digest as their host copy);
- :mod:`.store` — :class:`DiagramCache`, a thread-safe byte-budgeted LRU
  of ``DiagramResult`` wire payloads; ``get(key, epsilon)`` serves any
  entry whose ``error_bound <= epsilon``, and ``put`` only tightens;
- :mod:`.admission` — :class:`AdmissionPolicy`: under queue pressure,
  deadline-less exact requests degrade to bounded-error ones, and past a
  hard threshold new work is refused with
  :class:`ServiceOverloadedError`.

``TopoService(cache=..., admission=...)`` (``repro_torch.serve``) is the
front door.
"""

from .admission import (ACCEPT, DEGRADE, SHED,  # noqa: F401
                        AdmissionPolicy, ServiceOverloadedError,
                        degrade_request)
from .fingerprint import (KEY_SCHEMA, CacheKeyError,  # noqa: F401
                          fingerprint_array, fingerprint_field, request_key)
from .store import CacheEntry, DiagramCache  # noqa: F401
