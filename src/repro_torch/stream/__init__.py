"""Out-of-core streaming execution engine (paper Sec. V-C analogue).

PyTorch counterpart of ``repro.stream``: chunked field sources + z-slab
ghost decomposition (``chunks``), the double-buffered block scheduler
running the fused CUDA kernel's halo entry per chunk on rank-free
(value, vid) keys packed on the device (``scheduler``), the overlapped
sharded-streaming engine where every shard streams its z-slab on a CUDA
stream of its own and the halo exchange hides behind chunk compute
(``sharded``), and the ``PersistencePipeline.diagram_stream`` front door
in ``repro_torch.pipeline``.
"""

from .chunks import (ArraySource, CacheKeyError, Chunk,  # noqa: F401
                     DecimatedSource, FieldSource, FunctionSource,
                     MemmapSource, as_source, pack_value_keys,
                     pack_value_keys_torch, plan_chunks, plan_shards,
                     sortable32, unpack_value_keys, unpack_value_keys_torch)
from .scheduler import (SparseOrder, StreamReport,  # noqa: F401
                        StreamResult, diagram_vertices, ranks_for_vids,
                        stream_front)
from .sharded import (HaloExchange, HaloExchangeTimeout,  # noqa: F401
                      sharded_stream_front)
