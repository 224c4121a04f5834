"""What the per-layer readers in ``metrics/`` share."""

from __future__ import annotations

from statistics import mean
from typing import Optional


def stage_mean(ctx, *names) -> Optional[float]:
    """Mean over the window's diagrams of the seconds the program's
    ``StageReport`` gives the stages ``names`` together; None outside a
    pipeline run or where no diagram reports them."""
    if ctx.get("kind") != "pipeline":
        return None
    vals = [sum(s[n] for n in names) for s in ctx["stats"]
            if all(n in s for n in names)]
    return mean(vals) if vals else None


def idle_share(ctx, kind: str) -> Optional[float]:
    """Percent of the traced window in which no kernel, copy or set ran
    on the device, in a run of the driver ``kind``."""
    dt = ctx.get("trace")
    if ctx.get("kind") != kind or not dt or dt["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])


def step_mean(ctx, *names) -> Optional[float]:
    """Mean over the window's ``run_front`` calls of the seconds rank 0's
    ``stats["steps"]`` gives the steps ``names`` together; None outside a
    ring run or where no call reports them."""
    if ctx.get("kind") != "ring":
        return None
    vals = [sum(s[n] for n in names) for s in ctx["steps"]
            if all(n in s for n in names)]
    return mean(vals) if vals else None
