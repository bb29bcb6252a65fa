"""The serving loop: a closed loop of letterboxed batches through
``MultiGridInference.infer_batch`` and ``fetch_detections``.

The traffic file gives the name of the cell's rate (``rate``), the
batch, the number of batches in flight
(``pipeline_depth``, as ``detect_batch`` keeps them), the detection
settings, the frame size, how many distinct batches the loop cycles
through, how many finished batches the check compares and how many the
trace covers.  A batch is due when its slot frees (the previous fetch has
returned) and done when its detections are on the host; its latency is
the time between.  Only batches done inside the window count.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque

import numpy as np
import torch

from bench_port.harness import check_serve, device, frames, trace, weights
from bench_port.reference.detect import decode, popmax_nms
from bench_port.reference.model import Net


def inputs(traffic: dict, config: dict, seed: int, dev):
    """The distinct batches the loop cycles through: host uint8 canvases
    ``[B, H, W, 3]``, letterboxed on the device from seeded frames."""
    g = frames.generator(seed, dev)
    hw = tuple(config['input_shape'][:2])
    out = []
    for _ in range(traffic['distinct_batches']):
        f, _ = frames.photo_frames(traffic['batch'],
                                   tuple(traffic['frame_hw']),
                                   traffic['rects'], g, dev)
        out.append(frames.letterbox(f, hw).cpu().numpy())
    return out


def engine_config(config: dict, traffic: dict, anchors_path: str) -> dict:
    shape = list(config['input_shape'])
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': config['architecture'],
            'num_classes': config['num_classes'], 'input_shape': shape,
            'anchors_path': anchors_path}},
        'environment': {'mixed_precision': config['mixed_precision']},
        'input': {'type': 'image', 'input_shape': shape},
        'detection': dict(traffic['detection']),
    }


@contextlib.contextmanager
def anchors_file(config: dict):
    """The configuration's anchors as the port reads them (one line per
    scale, coarse first), in a temporary file."""
    fd, path = tempfile.mkstemp(suffix='.txt')
    try:
        with os.fdopen(fd, 'w') as f:
            for level in config['anchors']:
                f.write(', '.join(f'{w},{h}' for w, h in level) + '\n')
        yield path
    finally:
        os.remove(path)


def reference_net(config: dict, seed: int, dev, canvases,
                  mark=lambda phase: None) -> Net:
    """The reference network with the seed's weights, its BatchNorm
    statistics taken on ``canvases`` (the seed's first batch)."""
    net = Net(config['reference'], [len(a) for a in config['anchors']],
              config['num_classes'])
    mark('reference')
    weights.fill(net, seed, dev)
    mark('weights')
    weights.calibrate(net, torch.as_tensor(canvases).to(dev), seed)
    mark('calibrate')
    return net


def _half_batch(engine, infer):
    def wrapped(batch):
        b, c, s, v = infer(batch)
        v = v.clone()
        v[v.shape[0] // 2:] = False
        return b, c, s, v
    return wrapped


def _altered(engine, infer):
    def wrapped(batch):
        b, c, s, v = infer(batch)
        return b + 16.0, c, s, v
    return wrapped


def _box_scale(engine, infer):
    def wrapped(batch):
        b, c, s, v = infer(batch)
        x, y, w, h = b.unbind(-1)
        return (torch.stack([x - 0.05 * w, y - 0.05 * h, 1.1 * w, 1.1 * h],
                            -1), c, s, v)
    return wrapped


def _no_mean(engine, infer):
    with torch.no_grad():
        for m in engine.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.zero_()
    return infer


# planted by the harness's own tests and calibration only: half of the
# batch's detections left out; every box moved by half a coarse cell
# where the step produces it; every box's width and height scaled by 1.1
# about its centre; inference's BatchNorm without its running mean
FAULTS = {'half_batch': _half_batch, 'altered': _altered,
          'box_scale': _box_scale, 'no_mean': _no_mean}


class Loop:
    """The closed loop over one engine.  ``run(seconds)`` returns the
    finished batches; ``pending`` holds what is in flight."""

    def __init__(self, engine, batches, depth: int, spans: trace.Spans,
                 fault=None):
        from multigriddet_tpu_torch.training.steps import fetch_detections
        self.engine, self.batches, self.depth = engine, batches, depth
        self.infer = (FAULTS[fault](engine, engine.infer_batch) if fault
                      else engine.infer_batch)
        self.fetch = fetch_detections
        self.spans = spans
        self.next = 0
        self.pending: deque = deque()

    def _submit(self):
        k = self.next % len(self.batches)
        self.next += 1
        due = time.perf_counter()
        with self.spans.span('bench.enqueue'):
            out = self.infer(self.batches[k])
        self.pending.append((due, out, k))

    def _retire(self):
        due, out, k = self.pending.popleft()
        with self.spans.span('bench.fetch'):
            dets = self.fetch(out)
        return {'due': due, 'done': time.perf_counter(), 'input': k,
                'dets': dets}

    def run(self, seconds: float):
        done = []
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self._submit()
            if len(self.pending) > self.depth:
                done.append(self._retire())
        return done

    def count(self, n: int):
        """Submit ``n`` batches and retire as the loop does; returns n."""
        for _ in range(n):
            self._submit()
            if len(self.pending) > self.depth:
                self._retire()
        return n

    def drain(self):
        out = []
        while self.pending:
            out.append(self._retire())
        return out


def run(cell, fault=None) -> dict:
    """``fault``: one of :data:`FAULTS` (the harness's own tests)."""
    from multigriddet_tpu_torch.inference import MultiGridInference
    config, traffic, dev = cell.config, cell.traffic, cell.device
    spans = trace.Spans()
    cell.mark('imports')
    batches = inputs(traffic, config, cell.seed, dev)
    cell.mark('inputs')
    net = reference_net(config, cell.seed, dev, batches[0], cell.mark)
    with anchors_file(config) as path:
        engine = MultiGridInference(engine_config(config, traffic, path),
                                    device=dev)
    weights.load_port(engine.model, net)
    cell.mark('engine')
    loop = Loop(engine, batches, traffic['pipeline_depth'], spans, fault)
    # warm-up: every shape of the window (one batch size, one canvas)
    loop.count(traffic['warmup_batches'])
    loop.drain()
    device.sync(dev)
    cell.mark('warm-up')
    spans.durations.clear()
    setup_s = time.perf_counter() - cell.t0

    t_start = time.perf_counter()
    finished = loop.run(cell.seconds)
    t_end = t_start + cell.seconds
    in_window = [r for r in finished if r['done'] <= t_end]
    late = [r for r in finished if r['done'] > t_end] + loop.drain()
    device.sync(dev)
    memory_peak = device.peak_bytes(dev)
    b = traffic['batch']
    lat = [1e3 * (r['done'] - r['due']) for r in in_window]
    e2e = {
        traffic['rate']: (len(in_window) * b / cell.seconds, 'img/s'),
        'setup_s': (setup_s, 's'),
    }
    data = {'spans': {k: list(v) for k, v in spans.durations.items()},
            'batch': b, 'img_per_s': e2e[traffic['rate']][0],
            'p95_ms': float(np.percentile(lat, 95)) if lat else None,
            'window_batches': len(in_window)}
    traced_inputs = []
    if cell.trace:
        start = loop.next
        n = traffic['trace_batches']

        def stretch():
            loop.count(n)
            loop.drain()
            return n
        data['trace'] = trace.take(stretch, spans, dev)
        traced_inputs = [(start + i) % len(batches) for i in range(n)]

    del engine, loop
    device.empty_cache(dev)
    done = in_window + late
    rng = np.random.default_rng(cell.seed)
    pick = rng.choice(len(done), size=min(traffic['check_batches'],
                                          len(done)), replace=False)
    sample = [done[i] for i in sorted(pick)]
    readings, pairs = check(config, traffic, net, batches, sample,
                            traced_inputs, dev)
    if cell.trace:
        data['popmax_pairs'] = pairs
    return {'e2e': e2e, 'data': data, 'check': readings,
            'attempted': (len(in_window) + len(late)) * b,
            'failed': 0, 'memory_peak_bytes': memory_peak}


def reference_pool(net, config, canvases, dev):
    """The reference's float32 forward and decode of uint8 canvases."""
    x = torch.as_tensor(canvases).to(dev).float() / 255.0
    with torch.no_grad(), device.float32_exact():
        maps = net(x)
        return decode(maps, config['anchors'], tuple(x.shape[1:3]))


def check(config, traffic, net, batches, sample, traced_inputs, dev):
    """The correctness numbers over ``sample`` (finished batches), and
    the pop-max kernel's pairs summed over the traced inputs."""
    det = traffic['detection']
    conf, thr = det['confidence_threshold'], det['nms_threshold']
    readings = []
    for r in sample:
        ref = reference_pool(net, config, batches[r['input']], dev)
        readings.append(check_serve.compare(ref, r['dets'], conf, thr,
                                            det['max_boxes']))
        del ref
    pairs = 0
    for k in sorted(set(traced_inputs)):
        ref = reference_pool(net, config, batches[k], dev)
        *_, p = popmax_nms(ref['boxes'], ref['scores'], ref['classes'], conf,
                           thr, det['max_boxes'])
        pairs += p * traced_inputs.count(k)
        del ref
    return check_serve.worst(readings), pairs
