"""Reading a ``torch.profiler`` run: device intervals, their union, the idle
gaps and what the host was doing in them, and per-name device time.

Device time is the union of every kernel, copy and fill interval on the
device, so that work overlapping on two streams counts once.  The traced
window runs from the start of the first profiled call to the end of the
last (each call a ``record_function`` range that ends after the call's
``torch.cuda.synchronize()``), in the profiler's own clock.
"""

from __future__ import annotations

import bisect
import collections

CALL_RANGE = "benchmark.call"


def _start_end(e):
    if hasattr(e, "start_ns"):
        start = e.start_ns()
    else:
        start = e.start_us() * 1000
    return start, start + e.duration_ns()


def events(prof):
    """(device events, host events): lists of (name, start_ns, end_ns)
    from the profiler's raw kineto events."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _start_end(e)
        item = (e.name(), start, end)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the call ranges appear on the device's timeline too
            if end > start and e.name() != CALL_RANGE:
                dev.append(item)
        else:
            host.append(item)
    return dev, host


def union(intervals):
    """Merged [(start, end)] of possibly overlapping intervals, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(busy, lo, hi):
    """The idle intervals of [lo, hi) between merged busy intervals."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def host_op_at(host, starts, t, look_back=4096):
    """The innermost host event (the latest started) running at t; host is
    sorted by start and starts its start times."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        name, s, e = host[j]
        if e > t:
            return name
    return "(no host event)"


def read(prof, calls):
    """The profiled window's device reading: busy_s, window_s, per-name
    device seconds {name: s} and the idle seconds by the host event
    running at each gap's middle, both summed over the window."""
    dev, host = events(prof)
    ranges = [(s, e) for name, s, e in host if name == CALL_RANGE]
    if len(ranges) != calls or not dev:
        return None
    lo, hi = min(s for s, _ in ranges), max(e for _, e in ranges)
    busy = union(clip([(s, e) for _, s, e in dev], lo, hi))
    by_name = collections.Counter()
    for name, s, e in dev:
        if e > lo and s < hi:
            by_name[name] += (min(e, hi) - max(s, lo)) / 1e9
    host = sorted((h for h in host if h[0] != CALL_RANGE),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = collections.Counter()
    for s, e in gaps(busy, lo, hi):
        idle[host_op_at(host, starts, (s + e) // 2)] += (e - s) / 1e9
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (hi - lo) / 1e9, "device_s": dict(by_name),
            "idle_s": dict(idle)}
