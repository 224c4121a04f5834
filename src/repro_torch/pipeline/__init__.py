"""The persistence-diagram pipeline of the PyTorch port.

- :mod:`.request`  — :class:`TopoRequest` and :func:`resolve_grid`;
- :mod:`.plan`     — :class:`Plan` (``lower``) and the offset-table
  :class:`PlanCache`;
- :mod:`.result`   — :class:`DiagramResult` (``pairs``, ``essential``,
  ``betti``, ``arrays``) and the DDMS v1 wire format (``to_bytes`` /
  ``from_bytes``);
- :mod:`.stages`   — the stage chain and :class:`StageReport`;
- :mod:`.backends` — gradient backends (``fused``, ``prepass``,
  ``torch``) and sandwich back-ends (``torch``);
- :mod:`.api`      — :class:`PersistencePipeline` (``run``, ``run_batch``,
  ``diagram_stream``).
"""

from .api import PersistencePipeline  # noqa: F401
from .backends import (Backend, BackendCaps, SandwichBackend,  # noqa: F401
                       UnknownBackendError, UnknownSandwichBackendError,
                       available_backends, available_sandwich_backends,
                       get_backend, get_sandwich_backend, register_backend,
                       register_sandwich_backend)
from .plan import Plan, PlanCache  # noqa: F401
from .request import TopoRequest, resolve_grid  # noqa: F401
from .result import WIRE_MAGIC, WIRE_VERSION, DiagramResult  # noqa: F401
from .stages import (ALL_STAGES, BACK_STAGES, FRONT_STAGES,  # noqa: F401
                     PipelineState, StageReport, run_stages)
