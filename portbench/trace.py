"""One unit of work under torch.profiler, read in memory: the device's
busy union, the time by device operation, the longest idle gaps labelled
by what the host was doing, and the kernel times of named kernels in
launch order.

A 1000-pose map records about a million events, so only one unit is
profiled, never the window.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np

TOP = 10


def _union(spans):
    """Seconds covered by [start, end) intervals (microseconds in)."""
    busy, end = 0.0, -np.inf
    merged = []
    for t0, t1 in spans:
        if t1 <= end:
            continue
        if t0 > end:
            merged.append([t0, t1])
        else:
            merged[-1][1] = t1
        busy += t1 - max(t0, end)
        end = t1
    return busy * 1e-6, merged


def profile(fn: Callable[[], object], device, kernels=()) -> Dict:
    """Run fn once under the profiler.  Returns busy_s, window_s (the
    profiled wall), device_ops, idle_gaps and, for each name in
    ``kernels``, the device seconds of each launch whose name holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host, labels = [], [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(span)
        elif e.is_user_annotation():
            labels.append(span)
        else:
            host.append(span)
    dev.sort()
    busy, merged = _union([(a, b) for a, b, _ in dev])
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    labels, host = _arrays(labels), _arrays(host)
    idle = []
    for g0, g1 in gaps[:TOP]:
        mid = 0.5 * (g0 + g1)
        idle.append([_label(mid, *labels) + "/" + _label(mid, *host),
                     (g1 - g0) * 1e-6])
    per_kernel = {k: [(b - a) * 1e-6 for a, b, name in dev if k in name]
                  for k in kernels}
    return {"busy_s": busy, "window_s": wall, "device_ops": [list(o) for o in ops],
            "idle_gaps": idle, "kernels": per_kernel}


def _arrays(spans):
    return (np.array([a for a, _, _ in spans]), np.array([b for _, b, _ in spans]),
            [n for _, _, n in spans])


def _label(t, starts, ends, names):
    """The innermost span holding time t, or 'none'."""
    if not len(starts):
        return "none"
    hold = np.nonzero((starts <= t) & (ends >= t))[0]
    if not len(hold):
        return "none"
    return names[hold[np.argmax(starts[hold])]]
