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
- :class:`GroupRing` — ``Bl = n_blocks / world`` consecutive blocks per
  rank of a ``torch.distributed`` process group: the same ops inside the
  rank's stack, and across ranks ``batch_isend_irecv`` (one edge block
  per shift), ``all_gather_into_tensor``, ``all_to_all_single`` and
  ``all_reduce``.  gloo on the CPU, NCCL across cards, one rank per card.
  Under an active trace each of them is a sub-span ``comm.<op>``
  (``obs.trace.sub_span``) on the calling stream, from just before the
  collective is queued (a shift: from its wait) to just after its wait:
  the time the caller's stream spends waiting on the group.

:func:`block_ring` chooses between them.  Shapes, for ``x`` of shape
``(Bl, ...)``: ``shift`` and the reductions keep it; ``all_gather``
returns ``(Bl, n_blocks, ...)``; ``all_to_all`` takes and returns ``(Bl,
n_blocks, ...)``, where ``out[b, s]`` is what block ``s`` put in ``x[s,
b]``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.obs.trace import sub_span


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
    """Every block in this process, stacked on dim 0 on one device
    (``None`` means ``"cuda"``, which must be available)."""

    def __init__(self, n_blocks: int, device=None):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LocalRing runs on CUDA by default, and CUDA "
                               "is not available; pass device='cpu'")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.n_blocks = int(n_blocks)
        self.device = dev

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
    """``Bl = n_blocks / world`` consecutive blocks per rank of a
    ``torch.distributed`` process group: rank ``r`` holds blocks ``r*Bl``
    to ``r*Bl + Bl - 1``, stacked on dim 0.  ``n_blocks`` defaults to the
    world size (one block per rank).

    ``device`` is where this rank's tensors live, of a type the group's
    backend drives (``dist.get_backend_config``; gloo's CUDA tensors do
    not count).  It defaults to the current CUDA device where the group
    drives CUDA (NCCL), else the CPU (gloo); another device raises."""

    def __init__(self, group=None, device=None, n_blocks=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        n_blocks = self.world if n_blocks is None else int(n_blocks)
        if n_blocks < 1 or n_blocks % self.world:
            raise ValueError(
                f"n_blocks={n_blocks} does not divide over the {self.world} "
                f"ranks of the process group; choose a multiple of "
                f"{self.world}")
        self.n_blocks = n_blocks
        self.bl = n_blocks // self.world
        config = dist.get_backend_config(group)   # "cpu:gloo,cuda:nccl"
        by_type = dict(p.split(":") for p in config.split(","))
        drives = [t for t in ("cuda", "cpu") if t in by_type]
        if by_type.get("cuda") == "gloo":
            drives.remove("cuda")     # gloo stages CUDA through the host
        dev = torch.device(device if device is not None
                           else drives[0] if drives else "cpu")
        if dev.type not in drives or dev.type == "cuda" and \
                dev.index not in (None, torch.cuda.current_device()):
            raise ValueError(
                f"the process group ({config}) runs its ring on "
                f"{' or '.join(drives) or 'no device'}, not on {dev}; run "
                f"on the group's device")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev

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
        lo = self.rank * self.bl
        return torch.arange(lo, lo + self.bl, dtype=torch.int64,
                            device=self.device)

    def shift_async(self, x, up, wrap=False):
        # the roll moves the blocks inside the rank; the edge slot takes
        # the neighbouring rank's edge block (zeros at the ring's ends
        # unless ``wrap``; at world 1 the roll alone wraps)
        dist, w, r = self._dist, self.world, self.rank
        out = torch.roll(x, 1 if up else -1, dims=0)
        edge = 0 if up else -1
        if w == 1:
            if not wrap:
                out[edge] = 0
            return lambda: out
        send = self._wire(x[-1 if up else 0])
        recv = torch.empty_like(send)
        dst, src = (r + 1, r - 1) if up else (r - 1, r + 1)
        has_src = wrap or 0 <= src < w
        ops = []
        if wrap or 0 <= dst < w:
            ops.append(dist.P2POp(dist.isend, send, self._peer(dst % w),
                                  self.group))
        if has_src:
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src % w),
                                  self.group))
        else:
            out[edge] = 0
        reqs = dist.batch_isend_irecv(ops)

        def wait():
            # under NCCL, wait() orders the receive before the copy on
            # the current stream
            with sub_span("comm.shift", self.device):
                for q in reqs:
                    q.wait()
            if has_src:
                out[edge] = recv.to(x.dtype)
            return out
        return wait

    def all_gather(self, x):
        src = self._wire(x).reshape(-1)
        out = torch.empty(self.world * src.numel(), dtype=src.dtype,
                          device=src.device)
        # all_gather_single replaces all_gather_into_tensor in newer torch
        gather = getattr(self._dist, "all_gather_single", None) \
            or self._dist.all_gather_into_tensor
        with sub_span("comm.all_gather", self.device):
            gather(out, src, group=self.group)
        out = out.to(x.dtype).reshape((self.n_blocks,) + x.shape[1:])
        return out[None].expand((self.bl,) + out.shape)

    def all_to_all(self, x):
        # one chunk of Bl x Bl (source, destination) block pairs per
        # destination rank; recv[p, i, j] is what block p*Bl + i put in
        # x[., j]
        w, bl, tail = self.world, self.bl, x.shape[2:]
        send = self._wire(x.reshape((bl, w, bl) + tail).transpose(0, 1))
        recv = torch.empty_like(send)
        with sub_span("comm.all_to_all", self.device):
            self._dist.all_to_all_single(recv, send, group=self.group)
        return recv.to(x.dtype).reshape((self.n_blocks, bl) + tail) \
            .transpose(0, 1).contiguous()

    def _reduce(self, local, x, op, name):
        y = local.contiguous()
        with sub_span(name, self.device):
            self._dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.dtype).expand(x.shape)

    def psum(self, x):
        return self._reduce(self._wire(x).sum(0, keepdim=True), x,
                            self._dist.ReduceOp.SUM, "comm.psum")

    def pmax(self, x):
        return self._reduce(self._wire(x).amax(0, keepdim=True), x,
                            self._dist.ReduceOp.MAX, "comm.pmax")


def block_ring(n_blocks: int, device=None) -> Ring:
    """The ring of ``n_blocks`` blocks for this process: a
    :class:`GroupRing` over the default process group whenever one is
    initialised (``n_blocks`` must divide by its world size; the
    dry-run's ``fake`` group does not count), else a :class:`LocalRing`
    on ``device``.  Under a group every rank of it must make the call
    (each runs its own blocks and joins the ring's collectives), and
    ``device``, if given, must be one the group's ring runs on (see
    :class:`GroupRing`): nothing is copied to another one.  A rank-local
    run under a live group takes a ``LocalRing`` explicitly."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_backend() != "fake":
        return GroupRing(device=device, n_blocks=n_blocks)
    return LocalRing(n_blocks, device)
