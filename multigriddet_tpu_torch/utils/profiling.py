"""Profiling and timing utilities.

Counterpart of ``multigriddet_tpu/utils/profiling.py``:

* :func:`trace`: a ``torch.profiler`` capture of CPU and CUDA activity,
  written as a Chrome / Perfetto trace (``trace.json``) into a directory;
* :func:`span`: a named range of the program's host work, on the
  profiler's clock while a profiler runs and nothing otherwise, with
  :func:`span_totals` its count and host seconds by name;
* :class:`PhaseTimer`: accumulating named wall-clock phase timers;
* :func:`timed_op`: the time of one call of a function, with CUDA events
  on the card and the wall clock on the CPU, and optionally its share of
  the card's peak (FLOPs counted by ``FlopCounterMode``);
* :func:`null_wall`: the per-launch floor of a trivial CUDA kernel, the
  least time any call that launches a kernel can take.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

# dense bfloat16 tensor-core peaks (NVIDIA data sheets) by
# ``torch.cuda.get_device_name()``; other cards pass ``peak_flops``
PEAK_BF16_FLOPS: Dict[str, float] = {
    'NVIDIA H100 80GB HBM3': 989e12,    # H100 SXM5, at its 700 W limit
}

_NULL_WALL: Dict[int, float] = {}

# [count, host seconds] of each span by name, taken while a profiler runs
_SPAN_TOTALS: Dict[str, List[float]] = {}
_OFF = contextlib.nullcontext()


class _Span:
    """An open span: a profiler range of function scope, timed on the
    host clock into :data:`_SPAN_TOTALS`."""

    __slots__ = ('name', 'range', 't0')

    def __init__(self, name: str):
        self.name = name
        self.range = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        total = _SPAN_TOTALS.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += dt


def span(name: str):
    """``with span(name):`` marks the enclosed host work as ``name``.

    While a ``torch.profiler`` capture runs, the span is a range on the
    profiler's clock, among the CPU operations and the CUDA runtime calls
    of its thread, so a trace can put each idle gap of the device down to
    the span the host was in; its count and host seconds also go to
    :func:`span_totals`.  The range has function scope, as the ranges
    torch's compiled code opens: ``record_function``'s user scope would
    also mark each span on the device's timeline, from its first kernel
    to its last, where readers of device events count it as device work.
    With no profiler running the span costs one check."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return _OFF


def span_totals(reset: bool = False) -> Dict[str, List[float]]:
    """``{name: [count, host seconds]}`` of the spans closed while a
    profiler ran, since the process started or the last ``reset``."""
    out = {k: list(v) for k, v in _SPAN_TOTALS.items()}
    if reset:
        _SPAN_TOTALS.clear()
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the enclosed work (CPU and,
    with a card, CUDA) into ``log_dir/trace.json``; a no-op for ``None``.

    Yields the profiler (``None`` for no ``log_dir``), so a caller can
    also read its events.  The card is synchronized before the capture
    ends, so queued kernels are in it.  :func:`span_totals` starts anew
    with the capture."""
    if not log_dir:
        yield None
        return
    span_totals(reset=True)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def null_wall(loop: int = 16, repeats: int = 10) -> float:
    """Seconds per launch of a trivial CUDA kernel (an in-place multiply
    of one float), timed with CUDA events over ``repeats`` windows of
    ``loop`` launches; cached per ``loop`` for the process.  Needs a
    card."""
    if loop in _NULL_WALL:
        return _NULL_WALL[loop]
    if not torch.cuda.is_available():
        raise RuntimeError('null_wall needs a CUDA device')
    x = torch.ones(1, device='cuda')
    for _ in range(loop):
        x.mul_(0.9999)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats * loop):
        x.mul_(0.9999)
    end.record()
    end.synchronize()
    _NULL_WALL[loop] = start.elapsed_time(end) / 1e3 / (repeats * loop)
    return _NULL_WALL[loop]


def count_flops(fn, *args) -> int:
    """Floating-point operations of one call ``fn(*args)``, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matmuls and
    convolutions; elementwise work counts 0)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return int(counter.get_total_flops())


def timed_op(fn, *args, loop: int = 16, repeats: int = 3,
             with_mfu: bool = False, peak_flops: Optional[float] = None):
    """Seconds per call of ``fn(*args)``: two warm-up calls, then
    ``repeats`` windows of ``loop`` back-to-back calls, averaged.  With
    any argument on the card the windows are timed with CUDA events (the
    card's time, from the first launch to the last kernel's end);
    otherwise with the wall clock.

    ``with_mfu``: returns ``(seconds, mfu)``, the FLOPs of one call
    (:func:`count_flops`) per second over ``peak_flops``, by default the
    bfloat16 peak of the card in :data:`PEAK_BF16_FLOPS`."""
    card = _on_card(args)
    for _ in range(2):
        fn(*args)
    if card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(repeats):
            start.record()
            for _ in range(loop):
                fn(*args)
            end.record()
            end.synchronize()
            total += start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(repeats * loop):
            fn(*args)
        total = time.perf_counter() - t0
    dt = total / (repeats * loop)
    if not with_mfu:
        return dt
    if peak_flops is None:
        if not card:
            raise ValueError('timed_op: pass peak_flops for a run off the '
                             'card')
        name = torch.cuda.get_device_name()
        if name not in PEAK_BF16_FLOPS:
            raise ValueError(f'timed_op: no bfloat16 peak known for {name!r}'
                             '; pass peak_flops')
        peak_flops = PEAK_BF16_FLOPS[name]
    return dt, count_flops(fn, *args) / dt / peak_flops


class PhaseTimer:
    """Accumulating named phase timers (host wall clock)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f'{name:<24} {total:8.2f}s total '
                         f'({total / max(n, 1) * 1000:7.1f} ms x {n})')
        return '\n'.join(lines)
