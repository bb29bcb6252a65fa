"""Host spans of the benchmark, and the reading of a profiler trace.

``Spans`` records host-clock durations around the benchmark's calls into
the program; while a trace is taken each span is also a
``torch.profiler.record_function`` range, so the trace can say what the
host was doing in each idle gap of the device.

``summarize`` turns ``torch.profiler`` events into the numbers the
per-layer readers take: kernel count and time, time by operation name,
the device's busy time as the union of the intervals of its operations
(frozen from the port's ``profile_serve._union_us``), the window's
length on the host clock, and the idle gaps labelled by the benchmark
span and the outermost host operation running at their midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

# idle gaps labelled one by one, longest first
LABELLED_GAPS = 400


class Spans:
    def __init__(self):
        self.durations: Dict[str, List[float]] = defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                self.durations[name].append(time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            yield
            self.durations[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str):
        d = self.durations.get(name)
        return 1e3 * sum(d) / len(d) if d else None


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def take(stretch, spans: Spans, dev) -> dict:
    """Run ``stretch()`` under ``torch.profiler`` (host and device
    activity) and summarize it; ``stretch`` returns the count of units
    (batches or steps) it ran."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port.harness.device import sync
    activities = [ProfilerActivity.CPU]
    if torch.device(dev).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    sync(dev)
    spans.traced = True
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            units = stretch()
            sync(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        spans.traced = False
    return summarize(prof.events(), wall_us, units)


def summarize(events, wall_us: float, units: int) -> dict:
    """Device operations are the device's events less the ranges the
    benchmark's spans also mark on the device's timeline; kernels are the
    device operations less copies and fills."""
    dev = torch.autograd.DeviceType.CUDA
    ops = [e for e in events if e.device_type == dev
           and not e.name.startswith('bench.')]
    kernels = [e for e in ops if not e.name.startswith(('Memcpy', 'Memset'))]
    host = [e for e in events if e.device_type != dev]
    by_name: Dict[str, float] = defaultdict(float)
    for e in ops:
        by_name[e.name] += e.time_range.end - e.time_range.start
    intervals = sorted((e.time_range.start, e.time_range.end)
                       for e in ops)
    busy = union_us(intervals)
    gaps = []
    end = None
    for s, e in intervals:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    labelled: Dict[str, float] = defaultdict(float)
    # the benchmark's own thread: a producer thread's ops overlap it
    main = next((e.thread for e in host if e.name.startswith('bench.')),
                None)
    top = sorted((e for e in host
                  if e.cpu_parent is None and e.thread == main),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in top]
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        labelled[_label(top, starts, (g0 + g1) / 2)] += (g1 - g0) / 1e6
    return {
        'units': units,
        'wall_s': wall_us / 1e6,
        'busy_s': busy / 1e6,
        'kernels': len(kernels),
        'kernel_s': sum(e.time_range.end - e.time_range.start
                        for e in kernels) / 1e6,
        'by_name_s': {k: v / 1e6 for k, v in by_name.items()},
        'device_ops': sorted(([k, v / 1e6] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:10],
        'idle_gaps': sorted(([k, v] for k, v in labelled.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def _covering(events, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and events[i].time_range.end >= t:
        return events[i]
    return None


def _label(top, starts, t) -> str:
    """The benchmark span and the outermost host operation at time
    ``t``."""
    e = _covering(top, starts, t)
    if e is None:
        return 'outside spans / no host op'
    if not e.name.startswith('bench.'):
        return f'outside spans / {e.name}'
    kids = sorted(e.cpu_children, key=lambda k: k.time_range.start)
    op = _covering(kids, [k.time_range.start for k in kids], t)
    return f'{e.name} / {op.name if op is not None else "no host op"}'


