"""Device traces of replayed cycles, read from torch.profiler.

One span is one call profiled between two synchronizations. The card
runs one stream, so its kernels, copies and memsets do not overlap:
their durations add up to its busy time. The gaps between consecutive
device operations are the idle time, each labelled by the host
operation running at its middle and the device operation before it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


class Span(NamedTuple):
    wall_s: float                         # host clock, sync to sync
    busy_s: float                         # device operations' durations
    launches: int                         # device operations
    ops: Dict[str, Tuple[int, float]]     # name -> (count, seconds)
    gaps: List[Tuple[float, str]]         # the longest idle gaps


def profile_call(fn: Callable[[], None], device, keep_gaps: int = 10) -> Span:
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda r: r[0])
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda r: r[0])
    ops: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    busy = 0.0
    for a, b, name in dev:
        ops[name][0] += 1
        ops[name][1] += (b - a) * 1e-6
        busy += (b - a) * 1e-6
    gaps = []
    end, prev = None, "start"
    for a, b, name in dev:
        if end is not None and a > end:
            gaps.append((a - end, end, prev))
        if end is None or b > end:
            end, prev = b, name
    gaps.sort(reverse=True)
    labelled = []
    for g, at, before in gaps[:keep_gaps]:
        mid = at + g / 2
        inner = [h for h in host if h[0] <= mid <= h[1]]
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "idle"
        labelled.append((g * 1e-6, f"{what} after {before[:60]}"))
    return Span(wall, busy, len(dev), {k: (v[0], v[1]) for k, v in
                                       ops.items()}, labelled)


def kernel_seconds(span: Span, needle: str) -> Tuple[int, float]:
    """(count, seconds) of the device operations whose name holds
    `needle`."""
    n, s = 0, 0.0
    for name, (c, sec) in span.ops.items():
        if needle in name:
            n, s = n + c, s + sec
    return n, s
