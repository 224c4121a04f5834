"""Bounded-error and progressive persistence diagrams on the device.

PyTorch counterpart of ``repro.approx``: a power-of-two decimation
hierarchy whose per-level bounds come from a min/max pyramid computed on
the pipeline's device (:mod:`.hierarchy`), an engine that runs the
coarsest level meeting an ``epsilon`` (:mod:`.engine`), a coarse-to-fine
refinement walk with ``epsilon`` / ``deadline_s`` stopping
(:mod:`.progressive`), and the exact bottleneck distance that checks the
guarantee (:mod:`.metrics`, host numpy).

    from repro_torch.approx import approximate, refine

    res = approximate(pipe, TopoRequest(field=f), epsilon=0.05)
    res.error_bound                      # guaranteed d_B bound
    for res in refine(pipe, TopoRequest(field=f)):
        ...                              # shrinking bounds -> exact
"""

from .engine import APPROX_META, approximate, build_hierarchy  # noqa: F401
from .hierarchy import (Hierarchy, Level, block_minmax,  # noqa: F401
                        coarse_dims)
from .metrics import (bottleneck_distance, bottleneck_feasible,  # noqa: F401
                      essential_distance)
from .progressive import approximate_progressive, refine  # noqa: F401
