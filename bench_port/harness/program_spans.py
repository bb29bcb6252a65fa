"""The program's own spans in a traced stretch, and the host's calls that
block on the device.

The port marks its layers with ``multigriddet_tpu_torch.utils.profiling
.span``: ranges on the profiler's clock, directly under the benchmark's
spans (``bench.enqueue``, ``bench.fetch``, ``bench.step``), and a count
and host seconds of each by name while a profiler runs
(``span_totals``).

:func:`host_ms` is what the per-layer readers of the program's spans
take: host ms a unit (batch or step) of the traced stretch in one span,
from the program's totals.  A program without the spans, or a run
without a trace, reads None.

:func:`read` takes a profiler's events (``bench_port/keep_trace.py``):
the benchmark's and the program's spans on the benchmark's thread, the
share of each benchmark span's host time its program spans cover, and
the calls of :data:`BLOCKING` that thread makes inside the benchmark's
spans: their count, host seconds, and the program span each fell in.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict

# the program's spans under each benchmark span
UNDER = {'bench.enqueue': ('infer.upload', 'infer.step'),
         'bench.fetch': ('infer.fetch',),
         'bench.step': ('train.stage', 'train.forward', 'train.loss',
                        'train.backward', 'train.update')}
PROGRAM = tuple(n for names in UNDER.values() for n in names)

# CUDA runtime calls that return only when the device has reached them,
# by the names the profiler gives them (torch 2.11, CUDA 12.8, on the
# H100: the cells make cudaStreamSynchronize, for every copy to the host
# and every copy of a host constant to the card; cudaDeviceSynchronize
# comes from torch.cuda.synchronize; a copy from pageable memory is a
# cudaMemcpyAsync that waits inside, and is not counted)
BLOCKING = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
            'cudaEventSynchronize', 'cudaMemcpy')


def host_ms(run, name):
    tr = run['data'].get('trace')
    prof = sys.modules.get('multigriddet_tpu_torch.utils.profiling')
    totals = getattr(prof, 'span_totals', None)
    if not tr or not tr.get('units') or totals is None:
        return None
    t = totals().get(name)
    return 1e3 * t[1] / tr['units'] if t else None


def _us(e):
    return e.time_range.end - e.time_range.start


def read(events) -> dict:
    """Readings of a traced stretch from ``torch.profiler`` events; the
    units are the benchmark spans ``bench.enqueue`` or ``bench.step``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    main = next((e.thread for e in host if e.name.startswith('bench.')),
                None)
    spans = defaultdict(lambda: [0, 0.0])
    for e in host:
        if e.thread == main and (e.name in PROGRAM
                                 or e.name.startswith('bench.')):
            spans[e.name][0] += 1
            spans[e.name][1] += _us(e) / 1e6
    units = spans['bench.enqueue'][0] or spans['bench.step'][0]
    marks = sorted((e for e in host if e.thread == main
                    and e.name in PROGRAM), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in marks]
    bench = sorted(((e.time_range.start, e.time_range.end) for e in host
                    if e.thread == main and e.name.startswith('bench.')))
    bstarts = [s for s, _ in bench]
    blocking = defaultdict(lambda: [0, 0.0])
    where = defaultdict(int)
    for e in host:
        if e.name not in BLOCKING or e.thread != main:
            continue
        t = e.time_range.start
        i = bisect.bisect_right(bstarts, t) - 1
        if i < 0 or bench[i][1] < t:
            continue
        blocking[e.name][0] += 1
        blocking[e.name][1] += _us(e) / 1e6
        j = bisect.bisect_right(starts, t) - 1
        inside = j >= 0 and marks[j].time_range.end >= t
        where[marks[j].name if inside else 'no program span'] += 1
    cover = {}
    for b, names in UNDER.items():
        if spans.get(b, [0, 0.0])[1] > 0:
            cover[b] = sum(spans[n][1] for n in names
                           if n in spans) / spans[b][1]
    n = max(units, 1)
    return {'units': units,
            'ms_per_unit': {k: 1e3 * v[1] / n for k, v in spans.items()
                            if v[0]},
            'count_per_unit': {k: v[0] / n for k, v in spans.items()
                               if v[0]},
            'cover': cover,
            'blocking_per_unit': {k: v[0] / n for k, v in blocking.items()},
            'blocking_ms_per_unit': {k: 1e3 * v[1] / n
                                     for k, v in blocking.items()},
            'blocking_in': {k: v / n for k, v in where.items()}}
