"""One torch.profiler window on the card, read into what the per-layer
readers and the result's breakdown need: the device's kernels by name, the
union of their intervals (busy), the window's length, and its idle gaps by
the host operation that was running while the device waited. After
chip_smoke.py's _profile and kernel_split (commit 34b280c4)."""
from __future__ import annotations

import re
import time

import torch

_NAME = re.compile(r"(\w+)(<[^()]*>)?\(")


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    m = _NAME.search(name)
    return m.group(1) if m else name


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def record(fn, steps: int) -> dict:
    """Run fn() once under the profiler (after one unprofiled pass over the
    same work), synchronised at both ends. Returns {"steps", "kernels":
    [(short name, seconds)], "busy_s", "window_s", "gaps": [(host op,
    seconds)], "wall_s"}, the device's figures from the trace (CUPTI);
    window_s from the first recorded event's start to the last one's
    end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        (dev if e.device_type == DeviceType.CUDA else host).append(
            (e.name, span))
    if not dev:
        return {"steps": steps, "kernels": [], "busy_s": 0.0,
                "window_s": wall, "gaps": [], "wall_s": wall}
    lo = min(s for _, (s, _) in dev + host)
    hi = max(e for _, (_, e) in dev + host)
    busy = _union([span for _, span in dev])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    by_op = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [(e - s, name) for name, (s, e) in host if s <= mid <= e]
        op = min(inner)[1] if inner else "host, between operations"
        by_op[op] = by_op.get(op, 0.0) + (b - a)
    return {"steps": steps,
            "kernels": [(short_name(n), e - s) for n, (s, e) in dev],
            "busy_s": sum(e - s for s, e in busy), "window_s": hi - lo,
            "gaps": sorted(by_op.items(), key=lambda kv: -kv[1]),
            "wall_s": wall}


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds a step of the kernels whose short name matches the
    regular expression `pattern` (0.0 when none ran)."""
    rx = re.compile(pattern)
    return sum(s for n, s in trace["kernels"] if rx.search(n)) \
        / trace["steps"]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle time
    by host operation, each at most `top` [name, seconds] pairs."""
    by_name = {}
    for n, s in trace["kernels"]:
        by_name[n] = by_name.get(n, 0.0) + s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace["gaps"][:top]]}
