"""Admission control: graceful degradation + load-shedding for serving.

The port's copy of ``repro.cache.admission``; the one change is that the
field range of a torch tensor is read with one ``aminmax`` on its own
device.  Under light load the service answers every request at full fidelity.
Under pressure it has two production-shaped escape valves, applied *at
submit time* (before a request ever queues):

- **degrade** — past ``degrade_depth`` queued requests (or a p99
  latency past ``degrade_latency_s``), deadline-less requests are
  rewritten to bounded-error approximate requests instead of queueing
  at full cost: the approximation engine then answers them from
  the coarsest hierarchy level meeting their epsilon.  A request that
  already carries ``epsilon`` is already served at the coarsest
  qualifying level, and ``deadline_s`` / ``progressive`` requests
  self-limit — only *exact, deadline-less* requests have slack to
  give, so only they are degraded (to ``degrade_frac`` of their
  field's value range, stamped on the result as ``error_bound`` so the
  client always knows what it got).
- **shed** — past the hard ``shed_depth``, new work is rejected with a
  typed :class:`ServiceOverloadedError` carrying a retry hint, so a
  client (or load balancer) backs off instead of piling onto a queue
  that can no longer drain.

Decisions are pure functions of the observed pressure —
:meth:`AdmissionPolicy.decide` — so the policy is unit-testable
without a service and reusable by any front end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

#: decision labels returned by :meth:`AdmissionPolicy.decide`
ACCEPT = "accept"
DEGRADE = "degrade"
SHED = "shed"


class ServiceOverloadedError(RuntimeError):
    """The service refused new work (hard admission threshold).

    Carries the observed ``queue_depth`` and a ``retry_after_s`` hint —
    the client-visible half of load-shedding: back off and retry, the
    refusal is about *load*, not about the request."""

    def __init__(self, message: str, *, queue_depth: int,
                 retry_after_s: float):
        super().__init__(message)
        self.queue_depth = int(queue_depth)
        self.retry_after_s = float(retry_after_s)


@dataclass(frozen=True)
class AdmissionPolicy:
    """Thresholds + degradation budget for a serving queue.

    Parameters
    ----------
    degrade_depth : queue depth at which deadline-less exact requests
        degrade to bounded-error answers (None disables depth-based
        degradation).
    shed_depth : queue depth past which new requests are rejected with
        :class:`ServiceOverloadedError` (None disables shedding).
    degrade_latency_s : optional p99-latency threshold with the same
        effect as ``degrade_depth`` (either trigger degrades).
    degrade_frac : epsilon granted to a degraded request, as a fraction
        of its field's value range — the Vidal–Tierny bound then
        guarantees the served diagram is within ``degrade_frac *
        range`` of exact, in bottleneck distance.
    retry_after_s : the base retry hint stamped on shed errors, scaled
        by how far past the threshold the queue is.
    """

    degrade_depth: Optional[int] = 8
    shed_depth: Optional[int] = 64
    degrade_latency_s: Optional[float] = None
    degrade_frac: float = 0.05
    retry_after_s: float = 0.05

    def __post_init__(self):
        if self.degrade_depth is not None and self.degrade_depth < 0:
            raise ValueError(
                f"degrade_depth must be >= 0, got {self.degrade_depth}")
        if self.shed_depth is not None and self.shed_depth < 0:
            raise ValueError(
                f"shed_depth must be >= 0, got {self.shed_depth}")
        if (self.degrade_depth is not None and self.shed_depth is not None
                and self.shed_depth < self.degrade_depth):
            raise ValueError(
                f"shed_depth ({self.shed_depth}) must be >= degrade_depth "
                f"({self.degrade_depth}): shedding is the *harder* valve")
        if not 0 < self.degrade_frac:
            raise ValueError(
                f"degrade_frac must be > 0, got {self.degrade_frac}")
        if not self.retry_after_s > 0:
            raise ValueError(
                f"retry_after_s must be > 0, got {self.retry_after_s}")

    def decide(self, queue_depth: int,
               p99_latency_s: Optional[float] = None) -> str:
        """``"accept"`` / ``"degrade"`` / ``"shed"`` for the observed
        pressure (depth of queued-not-yet-collected requests, optional
        p99 of recent request latencies)."""
        if self.shed_depth is not None and queue_depth >= self.shed_depth:
            return SHED
        if self.degrade_depth is not None \
                and queue_depth >= self.degrade_depth:
            return DEGRADE
        if self.degrade_latency_s is not None and p99_latency_s is not None \
                and p99_latency_s >= self.degrade_latency_s:
            return DEGRADE
        return ACCEPT

    def overload_error(self, queue_depth: int) -> ServiceOverloadedError:
        """The typed rejection for a shed request, retry hint scaled to
        the overshoot (a queue twice over threshold hints twice the
        wait)."""
        scale = 1.0
        if self.shed_depth:
            scale = max(1.0, queue_depth / self.shed_depth)
        hint = self.retry_after_s * scale
        return ServiceOverloadedError(
            f"service overloaded: queue depth {queue_depth} >= shed "
            f"threshold {self.shed_depth}; retry in ~{hint:.3f}s",
            queue_depth=queue_depth, retry_after_s=hint)


def degrade_request(request, policy: AdmissionPolicy) -> Tuple[object, bool]:
    """``(request', degraded?)`` — the graceful-degradation rewrite.

    Only deadline-less *exact* requests change: they gain ``epsilon =
    degrade_frac * field range``, which the approximation engine
    answers from the coarsest level meeting it (or exactly, when no
    coarse level qualifies — degradation can soften an answer, never
    break it).  Requests that already carry ``epsilon`` /
    ``deadline_s`` / ``progressive`` pass through unchanged (they
    already bound their own cost), as do requests whose field range
    cannot be read cheaply (out-of-core sources)."""
    req = request
    if req.epsilon is not None or req.deadline_s is not None \
            or req.progressive:
        return req, False
    field = req.field
    if isinstance(field, torch.Tensor):
        if field.numel() == 0:
            return req, False
        lo, hi = torch.aminmax(field)
        rng = float(hi - lo)        # in the field dtype, as numpy does
        if rng <= 0:
            return req, False
        return req.replace(epsilon=policy.degrade_frac * rng), True
    if isinstance(field, np.ndarray) or (
            not hasattr(field, "read_slab") and field is not None):
        f = np.asarray(field)
        if f.size == 0:
            return req, False
        rng = float(f.max() - f.min())
        if rng <= 0:
            return req, False
        return req.replace(epsilon=policy.degrade_frac * rng), True
    return req, False
