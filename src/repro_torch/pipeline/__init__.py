"""The persistence-diagram pipeline of the PyTorch port.

- :mod:`.request`  — :class:`TopoRequest` and :func:`resolve_grid`;
- :mod:`.plan`     — :class:`Plan` (``lower``), ``Plan.compile`` ->
  :class:`Executable` (the rows program and offset tables bound through
  the :class:`PlanCache`);
- :mod:`.result`   — :class:`DiagramResult` (``pairs``, ``essential``,
  ``betti``, ``arrays``) and the DDMS v1 wire format (``to_bytes`` /
  ``from_bytes``);
- :mod:`.stages`   — the stage chain and :class:`StageReport`
  (``flat``, ``to_dict``);
- :mod:`.backends` — gradient backends (``fused``, ``prepass``,
  ``torch``, ``shardmap``, ``np``) and sandwich back-ends (``torch``,
  ``np``);
- :mod:`.api`      — :class:`PersistencePipeline` (``run``, ``run_batch``,
  ``compile``, ``diagram``, ``diagrams``, ``diagram_stream``) and its
  :class:`PipelineConfig`.
"""

from repro_torch.stream.scheduler import StreamReport  # noqa: F401


from .api import (PersistencePipeline, PipelineConfig,  # noqa: F401
                  PipelineResult)
from .backends import (Backend, BackendCaps, SandwichBackend,  # noqa: F401
                       UnknownBackendError, UnknownSandwichBackendError,
                       available_backends, available_sandwich_backends,
                       get_backend, get_sandwich_backend, register_backend,
                       register_sandwich_backend)
from .plan import (Executable, Plan, PlanCache,  # noqa: F401
                   default_plan_cache)
from .request import TopoRequest, resolve_grid  # noqa: F401
from .result import WIRE_MAGIC, WIRE_VERSION, DiagramResult  # noqa: F401
from .stages import (ALL_STAGES, BACK_STAGES, FRONT_STAGES,  # noqa: F401
                     PipelineState, StageReport, run_stages)
