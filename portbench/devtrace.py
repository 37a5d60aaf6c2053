"""The traced window: torch.profiler's raw events reduced in memory.

Copied from `chip_smoke.py::traced` (the port's proof script), which sums
the raw kineto events because building the profiler's per-event objects
(`key_averages()`) takes minutes for the 1e5-1e6 events of one solve.  Two
changes: the device's busy time is the union of its operations' intervals
inside the window (the sum, where they do not overlap, as on one stream),
and the idle gaps are named by the host operation that was running in the
middle of each.  No Chrome trace is written: the events are reduced here
and dropped.
"""

from __future__ import annotations

import bisect
import time

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")
WINDOW = "portbench.window"
TOP = 10
NAME_WIDTH = 120


def traced(torch, fn):
    """fn() once under the profiler (host and device activity); returns
    (fn's value, `summarize` of the events)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, summarize(prof.profiler.kineto_results.events(), wall)


def _union(intervals):
    """Merged (start, end) intervals of a list sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, wall_s: float) -> dict:
    """Reduce raw events (objects with name(), device_type(), start_ns(),
    duration_ns()) to:

      wall_s        the window's host wall (synchronised at both ends)
      busy_s        union of the device operations' intervals in the window
      launch_calls  cudaLaunch* / cuLaunch* / cudaGraphLaunch calls
      kernels       {name: [count, seconds]} of every device operation
      ordered       {name: [seconds, ...]} of each device operation in the
                    order it started
      device_ops    the 10 device operations that took most time
      idle_gaps     the 10 host operations under which the device sat idle
                    longest, [name, seconds]
    """
    from torch.autograd import DeviceType

    dev, host = [], []
    win = None
    launch_calls = 0
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (_annotation(e) or name == WINDOW or name.startswith("span.")):
                dev.append((start, dur, name))
            continue
        if name == WINDOW:
            win = (start, start + dur)
        elif name.startswith(LAUNCH_PREFIXES):
            launch_calls += 1
        host.append((start, start + dur, name))
    if win is None:
        lo = min([s for s, _, _ in dev] + [s for s, _, _ in host], default=0)
        hi = max([s + d for s, d, _ in dev] + [e for _, e, _ in host], default=0)
        win = (lo, hi)
    dev.sort()
    kernels, ordered = {}, {}
    clipped = []
    for s, d, name in dev:
        cnt, ns = kernels.get(name, (0, 0))
        kernels[name] = (cnt + 1, ns + d)
        ordered.setdefault(name, []).append(d / 1e9)
        s0, e0 = max(s, win[0]), min(s + d, win[1])
        if e0 > s0:
            clipped.append((s0, e0))
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)

    # idle gaps: between the busy intervals, and at both ends of the window
    host.sort()
    starts = [s for s, _, _ in host]
    gaps, cursor = {}, win[0]
    for s, e in busy + [[win[1], win[1]]]:
        if s > cursor:
            gaps_name = _host_at(host, starts, (cursor + s) // 2)
            gaps[gaps_name] = gaps.get(gaps_name, 0) + (s - cursor)
        cursor = max(cursor, e)
    by_time = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "wall_s": wall_s,
        "busy_s": busy_ns / 1e9,
        "launch_calls": launch_calls,
        "kernels": {k: [c, ns / 1e9] for k, (c, ns) in kernels.items()},
        "ordered": ordered,
        "device_ops": [[k[:NAME_WIDTH], ns / 1e9] for k, (_, ns) in by_time[:TOP]],
        "idle_gaps": [[k[:NAME_WIDTH], ns / 1e9] for k, ns in
                      sorted(gaps.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
    }


def _annotation(e) -> bool:
    """A record_function range that the profiler also draws on the device's
    track ("gpu_user_annotation"): no operation of the device."""
    kind = getattr(e, "activity_type", None)
    return bool(kind and "annotation" in str(kind()))


def _host_at(host, starts, t, reach=256):
    """Name of the innermost host operation running at time t: the latest
    started among those that have not ended (nested ranges on one thread);
    "host: no traced operation" where none is."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        s, e, name = host[j]
        if e >= t and name != WINDOW:
            return name
    return "host: no traced operation"
