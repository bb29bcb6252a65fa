"""The port's spans (``utils.profiling.span``) and what reads them.

Under a CPU ``torch.profiler`` capture the serve path records
``infer.upload``, ``infer.step`` and ``infer.fetch`` and the fused bank
train step ``train.stage``, ``train.forward``, ``train.loss``,
``train.backward`` and ``train.update``, once each, as siblings directly
under the caller's range; with no profiler running a span records
nothing and the results are the same.  The spans are ranges of function
scope, so the benchmark's trace summary reads the same device work with
them and labels the device's idle gaps by them; the benchmark's readers
of the spans take the program's totals over the traced stretch, and
``chip_smoke.py``'s readers of device events leave user annotations out.
The card's test (``-m cuda``) checks that no span reaches the device's
timeline.

    python -m pytest tests/test_torch_tracing.py -q
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import chip_smoke
from bench_port.harness import program_spans, trace
from multigriddet_tpu_torch.config import builder
from multigriddet_tpu_torch.inference import MultiGridInference
from multigriddet_tpu_torch.losses import LossConfig
from multigriddet_tpu_torch.models import create_model
from multigriddet_tpu_torch.training import (create_train_state,
                                             fetch_detections,
                                             make_fused_train_step)
from multigriddet_tpu_torch.utils import profiling
from multigriddet_tpu_torch.utils.profiling import span, span_totals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 64)
NC = 2
ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [15, 25], [25, 15]], np.float32),
           np.array([[10, 10], [8, 12], [12, 8]], np.float32)]
SERVE = ('infer.upload', 'infer.step', 'infer.fetch')
TRAIN = ('train.stage', 'train.forward', 'train.loss', 'train.backward',
         'train.update')
# the benchmark's readers of the program's spans
READERS = {f'{cell}.{k}_ms': f'infer.{s}' for cell in ('serve', 'video')
           for k, s in (('upload', 'upload'), ('launch', 'step'),
                        ('fetch', 'fetch'))}
READERS.update({f'train.{k}_ms': f'train.{k}' for k in
                ('stage', 'forward', 'loss', 'backward', 'update')})


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _in_order(events, names):
    return [e for e in sorted(events, key=lambda e: e.time_range.start)
            if e.name in names]


@pytest.fixture(scope='module')
def engine(tmp_path_factory):
    anchors = tmp_path_factory.mktemp('tracing') / 'anchors.txt'
    anchors.write_text('\n'.join(' '.join(f'{w},{h}' for w, h in a)
                                 for a in ANCHORS) + '\n')
    shape = [*HW, 3]
    return MultiGridInference({
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': NC,
            'input_shape': shape, 'anchors_path': str(anchors)}},
        'environment': {'mixed_precision': False},
        'input': {'type': 'image', 'input_shape': shape},
        'detection': {'confidence_threshold': 0.02, 'max_boxes': 10,
                      'nms_backend': 'pallas_fused'}}, device='cpu')


@pytest.fixture(scope='module')
def batch():
    return np.random.RandomState(0).randint(
        0, 256, (2, *HW, 3)).astype(np.uint8)


def _serve(engine, batch):
    with record_function('bench.enqueue'):
        outs = engine.infer_batch(batch)
    with record_function('bench.fetch'):
        return fetch_detections(outs)


def test_serve_records_its_spans_once_each_as_siblings(engine, batch):
    _, events = _profiled(
        lambda: fetch_detections(engine.infer_batch(batch)))
    got = _in_order(events, SERVE)
    assert [e.name for e in got] == list(SERVE)
    assert all(e.cpu_parent is None for e in got)
    # under the benchmark's ranges, each is a direct child of its call
    _, events = _profiled(lambda: _serve(engine, batch))
    got = _in_order(events, SERVE)
    assert [e.name for e in got] == list(SERVE)
    assert [e.cpu_parent.name for e in got] == [
        'bench.enqueue', 'bench.enqueue', 'bench.fetch']
    # function scope: no user annotation, so no range on a device timeline
    assert not any(e.is_user_annotation for e in got)


def test_bank_step_records_its_spans_once_each_in_order():
    torch.manual_seed(0)
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=NC).train()
    opt = builder.create_optimizer_from_config(
        {'training': {'learning_rate': 1e-3}, 'optimizer': {'type': 'adam'},
         'lr_schedule': {'type': 'constant'}}, model.parameters())
    state = create_train_state(model, opt)
    _, bank_step = make_fused_train_step(
        ANCHORS, NC, LossConfig(max_gt_boxes=8),
        aug_cfg={'enabled': True, 'enhance_type': 'mosaic',
                 'mosaic_prob': 1.0})
    rng = np.random.RandomState(1)
    bank = torch.from_numpy(rng.randint(0, 256, (3, *HW, 3)).astype(
        np.uint8))
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = [8, 8, 40, 40, 1]
    boxes[:, 1] = [30, 20, 60, 50, 0]

    def step():
        with record_function('bench.step'):
            return bank_step(state, (bank,), np.array([2, 0]), boxes,
                             torch.Generator().manual_seed(0))
    (_, metrics), events = _profiled(step)
    got = _in_order(events, TRAIN)
    assert [e.name for e in got] == list(TRAIN)
    assert all(e.cpu_parent.name == 'bench.step' for e in got)
    assert torch.isfinite(metrics['loss'])
    assert state.step == 1


def test_span_without_a_profiler_records_nothing(engine, batch):
    assert span('infer.step') is span('train.update')    # one shared no-op
    before = span_totals()
    plain = fetch_detections(engine.infer_batch(batch))
    assert span_totals() == before
    traced, _ = _profiled(
        lambda: fetch_detections(engine.infer_batch(batch)))
    after = span_totals()
    for name in SERVE:
        assert after[name][0] == before.get(name, [0, 0.0])[0] + 1
        assert after[name][1] > before.get(name, [0, 0.0])[1]
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def test_trace_capture_starts_the_totals_anew(engine, batch, tmp_path):
    _profiled(lambda: fetch_detections(engine.infer_batch(batch)))
    assert span_totals()['infer.step'][0] >= 1
    with profiling.trace(str(tmp_path)):
        fetch_detections(engine.infer_batch(batch))
    assert {k: v[0] for k, v in span_totals().items()} == {
        name: 1 for name in SERVE}
    assert (tmp_path / 'trace.json').is_file()


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, on_device, parent=None,
                 user=False):
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if on_device
                            else torch.autograd.DeviceType.CPU)
        self.thread, self.cpu_parent, self.cpu_children = 1, parent, []
        self.is_user_annotation = user
        if parent is not None:
            parent.cpu_children.append(self)


def _stretch(with_spans):
    """A traced step: host ops under ``bench.step``, optionally under the
    program's spans, and the device's work (two kernels and a copy)."""
    step = _Event('bench.step', 0, 100, False, user=True)
    host = [step]
    parent = step
    if with_spans:
        stage = _Event('train.stage', 0, 45, False, step)
        host += [stage, _Event('train.forward', 45, 100, False, step)]
        parent = stage
    host.append(_Event('aten::conv2d', 10, 20, False, parent))
    device = [_Event('bench.step', 10, 80, True, user=True),
              _Event('conv_kernel', 10, 30, True),
              _Event('Memcpy HtoD', 40, 50, True),
              _Event('bn_kernel', 70, 80, True)]
    return host + device


def test_trace_summary_reads_the_same_device_work_with_spans():
    without = trace.summarize(_stretch(False), wall_us=100.0, units=1)
    with_spans = trace.summarize(_stretch(True), wall_us=100.0, units=1)
    for k in ('kernels', 'kernel_s', 'busy_s', 'by_name_s', 'wall_s'):
        assert with_spans[k] == without[k], k
    assert without['idle_gaps'] == [['bench.step / no host op',
                                     pytest.approx(30e-6)]]
    # the gaps (30, 40) and (50, 70) now name the span the host was in
    assert dict(with_spans['idle_gaps']) == {
        'bench.step / train.stage': pytest.approx(10e-6),
        'bench.step / train.forward': pytest.approx(20e-6)}


def test_chip_smoke_reads_no_user_annotation_as_device_work():
    events = _stretch(True)
    work = chip_smoke.device_work(events)
    assert [e.name for e in work] == ['conv_kernel', 'Memcpy HtoD',
                                      'bn_kernel']
    busy = chip_smoke._union_us((e.time_range.start, e.time_range.end)
                                for e in work)
    assert busy == 40.0
    assert chip_smoke._group('sm90_xmma_fprop_implicit_gemm') == 'conv'
    assert chip_smoke._group('popmax_nms_kernel') == 'nms'


def test_program_spans_read_a_traced_serve_stretch(engine, batch):
    _, events = _profiled(lambda: [_serve(engine, batch) for _ in range(2)])
    r = program_spans.read(events)
    assert r['units'] == 2
    assert r['count_per_unit'] == {name: 1.0 for name in
                                   ('bench.enqueue', 'bench.fetch', *SERVE)}
    assert 0.5 < r['cover']['bench.enqueue'] <= 1.0
    assert 0.0 < r['cover']['bench.fetch'] <= 1.0
    assert r['blocking_per_unit'] == {}          # no CUDA runtime here


def _reader(metric):
    path = os.path.join(ROOT, 'bench_port', 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location(f'reader_{metric}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('metric', sorted(READERS))
def test_span_reader_reads_its_span_a_unit(metric, monkeypatch):
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        entry = {m['name']: m for m in json.load(f)['per_layer']}[metric]
    assert entry['source'] == 'program_span'
    assert entry['moves'] == {'serve': 'serve_img_per_s',
                              'video': 'video_img_per_s',
                              'train': 'train_img_per_s'}[
                                  metric.split('.')[0]]
    read = _reader(metric).read
    run = {'data': {'spans': {}, 'trace': {'units': 4}}, 'read': []}
    monkeypatch.setattr(profiling, '_SPAN_TOTALS',
                        {READERS[metric]: [4, 0.2], 'other': [4, 9.0]})
    assert read(run) == pytest.approx(50.0)
    assert read({'data': {'spans': {}}, 'read': []}) is None
    monkeypatch.setattr(profiling, '_SPAN_TOTALS', {'other': [4, 9.0]})
    assert read(run) is None


@pytest.mark.cuda
def test_spans_stay_off_the_devices_timeline(engine, batch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run with -m cuda on the card')
    card = MultiGridInference(
        {**engine.config, 'detection': dict(engine.config['detection'])},
        device='cuda')
    fetch_detections(card.infer_batch(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve(card, batch)
        torch.cuda.synchronize()
    events = prof.events()
    on_device = {e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not on_device & set(SERVE)
    assert 'bench.enqueue' in on_device     # record_function's user scope
    assert trace.summarize(events, 1e6, 1)['kernels'] > 10
