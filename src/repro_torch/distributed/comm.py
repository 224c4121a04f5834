"""The block ring: collectives of the distributed front-end.

PyTorch stand-in for the ``shard_map`` mesh axis of
``repro.distributed.shardmap_pipeline``.  The per-block program is written
over a leading *block axis*: every tensor it handles is ``(Bl, ...)``,
where ``Bl`` is the number of blocks this process holds.  The six
collectives the reference uses (``ppermute`` ring shifts with and without
wrap, ``all_gather``, ``all_to_all``, ``psum``, ``pmax``, ``axis_index``)
go through a :class:`Ring`:

- :class:`LocalRing` — all ``n_blocks`` blocks in one process, stacked on
  dim 0 of each tensor on one device (``Bl == n_blocks``).  A shift is a
  roll along dim 0 whose edge block is zero-filled (``ppermute`` without
  wrap), ``all_to_all`` a transpose of the (source, destination) axes,
  ``psum`` / ``pmax`` reductions over dim 0.  Every op covers all blocks
  at once; this is how ``n_blocks > 1`` runs on one card and in the CPU
  tests.
- :class:`GroupRing` — one block per rank of a ``torch.distributed``
  process group (``Bl == 1``): shifts through ``batch_isend_irecv``,
  ``all_gather_into_tensor``, ``all_to_all_single`` and ``all_reduce``.
  gloo on the CPU, NCCL across cards.

Shapes, for ``x`` of shape ``(Bl, ...)``: ``shift`` and the reductions
keep it; ``all_gather`` returns ``(Bl, n_blocks, ...)``; ``all_to_all``
takes and returns ``(Bl, n_blocks, ...)``, where ``out[b, s]`` is what
block ``s`` put in ``x[s, b]``.
"""

from __future__ import annotations

from typing import Callable

import torch


class Ring:
    """A ring of ``n_blocks`` blocks; this process holds ``blocks()``."""

    n_blocks: int
    device: torch.device

    def blocks(self) -> torch.Tensor:
        """(Bl,) int64 global indices of the blocks held here."""
        raise NotImplementedError

    def shift(self, x: torch.Tensor, up: bool,
              wrap: bool = False) -> torch.Tensor:
        """Move every block's ``x`` one block up (``up``: block i receives
        block i-1's) or down the ring; edge blocks receive zeros unless
        ``wrap``."""
        return self.shift_async(x, up, wrap)()

    def shift_async(self, x: torch.Tensor, up: bool,
                    wrap: bool = False) -> Callable[[], torch.Tensor]:
        """Start :meth:`shift`; the returned callable waits for it and
        gives the result (so a caller can compute while it is in flight)."""
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(n_blocks, ...) stack of every block's ``x`` (same on every
        holder)."""
        return self.all_gather(x)[0]


class LocalRing(Ring):
    """Every block in this process, stacked on dim 0 on one device."""

    def __init__(self, n_blocks: int, device=None):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.device = torch.device("cpu" if device is None else device)

    def blocks(self) -> torch.Tensor:
        return torch.arange(self.n_blocks, dtype=torch.int64,
                            device=self.device)

    def shift_async(self, x, up, wrap=False):
        out = torch.roll(x, 1 if up else -1, dims=0)
        if not wrap:
            out[0 if up else -1] = 0
        return lambda: out

    def all_gather(self, x):
        return x[None].expand(self.n_blocks, *x.shape)

    def all_to_all(self, x):
        return x.transpose(0, 1).contiguous()

    def psum(self, x):
        return x.sum(0, keepdim=True).expand(x.shape).to(x.dtype)

    def pmax(self, x):
        return x.amax(0, keepdim=True).expand(x.shape)

    def gather_blocks(self, x):
        return x


class GroupRing(Ring):
    """One block per rank of a ``torch.distributed`` process group.

    ``device`` is where this rank's tensors live: ``"cuda"`` under NCCL
    (the current device), the CPU under gloo (the default)."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_blocks = dist.get_world_size(group)
        if device is None:
            device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        self.device = torch.device(device)

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    @staticmethod
    def _wire(x: torch.Tensor) -> torch.Tensor:
        # gloo moves no bool tensors
        return (x.to(torch.uint8) if x.dtype == torch.bool
                else x).contiguous()

    def blocks(self):
        return torch.tensor([self.rank], dtype=torch.int64,
                            device=self.device)

    def shift_async(self, x, up, wrap=False):
        dist, nb, r = self._dist, self.n_blocks, self.rank
        send = self._wire(x[0])
        recv = torch.zeros_like(send)
        dst, src = (r + 1, r - 1) if up else (r - 1, r + 1)
        ops = []
        if nb > 1 and (wrap or 0 <= dst < nb):
            ops.append(dist.P2POp(dist.isend, send, self._peer(dst % nb),
                                  self.group))
        if nb > 1 and (wrap or 0 <= src < nb):
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src % nb),
                                  self.group))
        if nb == 1 and wrap:
            recv = send.clone()
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for q in reqs:
                q.wait()
            return recv.to(x.dtype)[None]
        return wait

    def all_gather(self, x):
        src = self._wire(x[0]).reshape(-1)
        out = torch.empty(self.n_blocks * src.numel(), dtype=src.dtype,
                          device=src.device)
        gather = getattr(self._dist, "all_gather_single", None) \
            or self._dist.all_gather_into_tensor
        gather(out, src, group=self.group)
        return out.to(x.dtype).reshape((1, self.n_blocks) + x.shape[1:])

    def all_to_all(self, x):
        src = self._wire(x[0])
        out = torch.empty_like(src)
        self._dist.all_to_all_single(out, src, group=self.group)
        return out.to(x.dtype)[None]

    def _reduce(self, x, op):
        y = self._wire(x).clone()
        self._dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.dtype)

    def psum(self, x):
        return self._reduce(x, self._dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, self._dist.ReduceOp.MAX)

