"""The benchmark finds every configuration, traffic mix, check, count and
per-layer metric by the names in ``BENCHMARK.json``, and its reference
matches the published layer counts and the frozen FLOP counts.

    python -m pytest bench_port/tests -q
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, 'bench_port')
sys.path.insert(0, ROOT)

from bench_port.counts.forward_flops import forward_flops  # noqa: E402
from bench_port.harness import weights  # noqa: E402
from bench_port.reference.model import BACKBONE_CONVS, Net  # noqa: E402
from bench_port.reference.train.replay import BN_MOMENTUM  # noqa: E402


def load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


BENCHMARK = load(ROOT, 'BENCHMARK.json')
CONFIGS = {c['name']: c for c in BENCHMARK['configs']}


def test_every_cell_finds_its_files():
    for w in BENCHMARK['workloads']:
        config = CONFIGS[w['config']]
        assert os.path.isfile(os.path.join(ROOT, config['file']))
        traffic = load(BENCH, 'traffic', f'{w["traffic"]}.json')
        assert os.path.isfile(os.path.join(
            BENCH, 'harness', f'{traffic["loop"]}.py'))
        limits = load(BENCH, 'checks', f'{w["name"]}.json')['numbers']
        assert limits and all(v < 1e6 for v in limits.values())
        counts = load(BENCH, 'counts', f'{w["config"]}.json')
        assert counts['forward_flops_per_image'] > 0


@pytest.mark.parametrize('metric', [m['name']
                                    for m in BENCHMARK['per_layer']])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    path = os.path.join(BENCH, 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location('reader', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    counts = {name[:-5]: load(BENCH, 'counts', name)
              for name in os.listdir(os.path.join(BENCH, 'counts'))
              if name.endswith('.json')}
    run = {'data': {'spans': {}}, 'config': 'darknet608', 'counts': counts,
           'read': []}
    assert mod.read(run) is None


def test_every_cell_reports_an_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK['workloads']:
        def applies(m):
            return 'workloads' not in m or w['name'] in m['workloads']
        e2e = {m['name'] for m in BENCHMARK['end_to_end'] if applies(m)}
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert any(applies(m) and m['moves'] in e2e
                   for m in BENCHMARK['per_layer'])


def test_reference_layer_counts():
    net = Net('darknet', (3, 3, 3), 80)
    convs = [u for u in net.units if not u.predict]
    # Darknet-53: 52 convolutions before its classifier (YOLOv3), and the
    # MultiGrid head's 14
    assert len(convs) == BACKBONE_CONVS['darknet'] + 14
    assert sum(u.predict for u in net.units) == 3
    assert sum(u.residual for u in net.units) == 23


@pytest.mark.parametrize('name', sorted(
    f[:-5] for f in os.listdir(os.path.join(BENCH, 'configs'))))
def test_frozen_flop_counts(name):
    config = load(BENCH, 'configs', f'{name}.json')
    assert forward_flops(config) == load(
        BENCH, 'counts', f'{name}.json')['forward_flops_per_image']


def test_reference_equals_the_port_in_float32():
    from multigriddet_tpu_torch.models import create_model
    model = create_model('multigriddet_darknet', num_anchors=(3, 3, 3),
                         num_classes=80, dtype=torch.float32).eval()
    net = Net('darknet', (3, 3, 3), 80)
    weights.fill(net, 2 ** 31 + 5, 'cpu')
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    weights.calibrate(net, (x * 255).round().to(torch.uint8), 2 ** 31 + 5)
    weights.load_port(model, net)
    with torch.no_grad():
        for train in (False, True):
            got = model(x, train=train)
            want = net(x, train=train)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                assert torch.allclose(g, w, rtol=1e-5, atol=1e-4)
    # the train-mode forward moved the port's running statistics once
    net.update_running(BN_MOMENTUM)
    ours = [t for k, t in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))]
    theirs = net.running()
    assert len(ours) == len(theirs) == 2 * 66
    for o, t in zip(ours, theirs):
        assert torch.allclose(o, t, rtol=1e-5, atol=1e-6)


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import bench_port.reference.model, bench_port.reference.detect\n'
            'import bench_port.reference.train.replay\n'
            'import bench_port.counts.forward_flops\n'
            'tops = {m.split(".")[0] for m in sys.modules}\n'
            'bad = tops & {"jax", "jaxlib", "flax", "multigriddet_tpu",\n'
            '              "multigriddet_tpu_torch"}\n'
            'print(sorted(bad)); sys.exit(1 if bad else 0)' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, 'run.py'), '--workload',
         BENCHMARK['workloads'][0]['name'], '--seed', str(2 ** 31 + 9),
         '--seconds', '1', '--trace', '0'], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, on_device, thread=1, parent=None):
        self.name, self.time_range = name, _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if on_device
                            else torch.autograd.DeviceType.CPU)
        self.thread, self.cpu_parent, self.cpu_children = thread, parent, []


def test_trace_summary_counts_device_work_only():
    from bench_port.harness.trace import summarize
    span = _Event('bench.step', 0, 100, False)
    op = _Event('aten::conv2d', 10, 20, False, parent=span)
    span.cpu_children = [op]
    events = [span, op,
              _Event('bench.step', 0, 100, True),     # the span's range
              _Event('conv_kernel', 10, 30, True),
              _Event('Memcpy HtoD', 40, 50, True),
              _Event('bn_kernel', 70, 80, True)]
    s = summarize(events, wall_us=100.0, units=1)
    assert s['kernels'] == 2
    assert s['kernel_s'] == pytest.approx(30e-6)
    assert s['busy_s'] == pytest.approx(40e-6)
    assert s['idle_gaps'][0][0] == 'bench.step / no host op'
