"""Where the device time of the fused serve step goes, on the card.

    python -m multigriddet_tpu_torch.profile_serve [--backend pallas_fused]
        [--report PATH] [--trace-dir DIR]

Builds ``MultiGridInference`` for ``multigriddet_darknet`` (80 classes,
COCO anchors, bfloat16, seeded random weights, confidence 0 so NMS sees
the whole pool), warms up, then records ten fused steps on a
device-resident b8 @608 uint8 batch with ``torch.profiler``.  Prints
device time by kernel group (convolution, elementwise and reductions, NMS
kernels, other), the costliest kernels, and the device's busy share of
the window (union of kernel intervals over the host-clock wall time).
The capture (``utils.profiling.trace``) is also written as a Chrome /
Perfetto trace into ``--trace-dir`` (default ``build/traces/profile_serve``
in the checkout).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import torch

from .utils.profiling import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE, STEPS = 8, 608, 10
_GROUPS = (
    ('nms', ('popmax', 'greedy')),
    ('conv', ('conv', 'cudnn', 'gemm', 'xmma', 'cutlass', 'sm90_',
              'implicit')),
    ('elementwise', ('elementwise', 'vectorized', 'unrolled', 'reduce',
                     'cat', 'upsample', 'copy', 'index', 'sort', 'softmax')),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--backend', default='pallas_fused',
                   choices=['pallas_fused', 'pallas', 'xla'])
    p.add_argument('--report', default=None)
    p.add_argument('--trace-dir',
                   default=os.path.join(REPO, 'build', 'traces',
                                        'profile_serve'))
    args = p.parse_args(argv)

    from .inference import MultiGridInference
    from .models import load_flax_variables, random_flax_variables
    anchors = os.path.join(REPO, 'configs', 'yolov3_coco_anchor.txt')
    shape = [SIZE, SIZE, 3]
    engine = MultiGridInference({
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_darknet', 'num_classes': 80,
            'input_shape': shape, 'anchors_path': anchors}},
        'environment': {'mixed_precision': True},
        'input': {'type': 'image', 'input_shape': shape},
        'detection': {'confidence_threshold': 0.0, 'nms_backend':
                      args.backend}})
    load_flax_variables(engine.model,
                        *random_flax_variables(engine.model, seed=0))
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (BATCH, *shape), generator=g,
                      dtype=torch.uint8).cuda()
    for _ in range(3):
        engine.infer_batch(x)
    torch.cuda.synchronize()

    with trace(args.trace_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            engine.infer_batch(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        by_group[_group(e.name)] += dt
        by_name[e.name] += dt
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    report = {
        'card': torch.cuda.get_device_name(0),
        'batch': BATCH, 'size': SIZE, 'backend': args.backend,
        'steps': STEPS, 'wall_ms_per_step': wall_us / STEPS / 1e3,
        'kernel_count_per_step': len(kernels) / STEPS,
        'device_busy_share': busy_us / wall_us if kernels else None,
        'group_ms_per_step': {k: v / STEPS / 1e3
                              for k, v in sorted(by_group.items())},
        'top_kernels_ms_per_step': [
            (name, t / STEPS / 1e3) for name, t in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:15]],
    }
    if not kernels:
        print('profile_serve: the profiler recorded no device kernels')
    print(json.dumps(report, indent=1))
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
