"""The device's side of a traced run, from ``torch.profiler``.

Device time is the time covered by the trace's device events (kernels,
copies, sets: the events of device type CUDA, less the user annotations
the profiler mirrors onto the device track), their intervals merged.
The aten ops that launched them carry the same time as their own device
time and are not counted again.  The window is the ``bench.window``
annotation the driver opens around its requests.

Idle gaps are named by the program's own span (``TopoRequest(trace=
True)``: its stages and pairing rounds) that was open on the host when
the gap began, or by the benchmark's own step, ``bench``, outside them.
The program's spans are on the host clock; the ``bench.request``
annotations, whose host times the driver notes, map them onto the
profiler's.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
REQUEST = "bench.request"


def profiler():
    """A profiler of host and device activity (not yet started)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(spans: Sequence[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(prof, request_host_s: Sequence[float] = (),
           host_spans: Sequence[Tuple[str, float, float]] = (),
           top: int = 10) -> Optional[dict]:
    """{busy_s, window_s, kernel_s (name -> seconds), kernel_n (name ->
    launches), device_ops, idle_gaps} of the traced window, or None if it holds no device
    event.  ``request_host_s`` are the host clock's readings at each
    ``bench.request`` annotation's start; ``host_spans`` the program's
    spans as (name, start, end) on that clock, in seconds."""
    from torch.autograd import DeviceType
    # the raw events: building the profiler's FunctionEvent tree for a
    # window of hundreds of thousands of ops takes minutes
    evs = [(e.name(), e.device_type(), e.start_ns() * 1e-3,
            e.end_ns() * 1e-3, e.is_user_annotation())
           for e in prof.profiler.kineto_results.events()]
    # the annotations as the host recorded them, not their device mirrors
    host = [e for e in evs if e[1] == DeviceType.CPU]
    win = [e for e in host if e[0] == WINDOW]
    if not win:
        return None
    w0, w1 = win[0][2], win[0][3]
    dev = []
    kernel_us: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    for name, dtype, s, t, annotation in evs:
        if dtype != DeviceType.CUDA or annotation:
            continue
        a, b = max(s, w0), min(t, w1)
        if b > a:
            dev.append((a, b))
            kernel_us[name] += b - a
            kernel_n[name] += 1
    if not dev:
        return None
    merged = _merge(dev)
    busy_us = sum(b - a for a, b in merged)
    # the host clock (s) -> the profiler's (us)
    marks = sorted(e[2] for e in host if e[0] == REQUEST)
    offset = None
    if marks and len(marks) == len(request_host_s):
        offset = sum(m - t * 1e6 for m, t in zip(marks, request_host_s)) \
            / len(marks)
    spans = []
    if offset is not None:
        spans = sorted((a * 1e6 + offset, b * 1e6 + offset, name)
                       for name, a, b in host_spans)
    starts = [s[0] for s in spans]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        name, best = "bench", None
        for j in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            s0, s1, nm = spans[j]
            if s0 <= a < s1 and (best is None or s1 - s0 < best):
                name, best = nm, s1 - s0
        idle[name] += (b - a) * 1e-6
    ops = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": {k: v * 1e-6 for k, v in kernel_us.items()},
            "kernel_n": dict(kernel_n),
            "device_ops": [[k[:160], v * 1e-6] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
