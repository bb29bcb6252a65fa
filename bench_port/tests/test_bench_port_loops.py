"""Each cell's loop at a tiny size on the CPU, through ``run.execute``
(everything of a run but the look for a card): a sound run comes out
correct, and a run with its timed path broken underneath, or the control
(the reference in float8 in the program's place), comes out not correct
against the cell's committed limits.  The card's own run is the
``cuda`` test at the end (the card's tests: ``python -m pytest -m cuda
bench_port/tests``).

    python -m pytest bench_port/tests -q
"""

import argparse
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

from bench_port import calibrate, run  # noqa: E402

BENCHMARK = run.load_json(ROOT, 'BENCHMARK.json')
CELLS = {w['name']: w for w in BENCHMARK['workloads']}
SERVE = [n for n, w in CELLS.items()
         if run.load_json(BENCH, 'traffic', f'{w["traffic"]}.json')['loop']
         == 'serve']
TRAIN = [n for n, w in CELLS.items() if n not in SERVE]
SEED = 2 ** 31 + 77


def tiny(name, train_hw=64, train_batch=4):
    """The cell's configuration and traffic cut to a CPU test's size:
    float32 (the card computes in bfloat16), a 256x256 canvas and four
    images a batch to serve, a ``train_hw`` canvas and ``train_batch``
    images a batch (of four batches of files) to train."""
    w = CELLS[name]
    config = run.load_json(BENCH, 'configs', f'{w["config"]}.json')
    traffic = run.load_json(BENCH, 'traffic', f'{w["traffic"]}.json')
    config.update(input_shape=[train_hw, train_hw, 3],
                  mixed_precision=False)
    if traffic['loop'] == 'serve':
        config.update(input_shape=[256, 256, 3])
        traffic.update(batch=4, distinct_batches=2, warmup_batches=1,
                       check_batches=2, trace_batches=2, frame_hw=[192, 256])
    else:
        traffic.update(images=4 * train_batch,
                       frame_hw=[train_hw * 3 // 4, train_hw],
                       warmup_steps=4, trace_steps=1)
        traffic['training']['batch_size'] = train_batch
    return w, config, traffic


def execute(name, trace=0, fault=None, seconds=1.0):
    w, config, traffic = tiny(name)
    args = argparse.Namespace(seed=SEED, seconds=seconds, trace=trace)
    torch.set_num_threads(4)
    return run.execute(args, w, BENCHMARK, torch.device('cpu'), config,
                       traffic, fault)


@pytest.mark.parametrize('name', SERVE + TRAIN)
def test_sound_run_is_correct(name):
    result = execute(name)
    assert result is not None
    assert result['correct'], result['check']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert 'setup_s' in result['metrics']


@pytest.mark.parametrize('name', SERVE[:1] + TRAIN)
def test_traced_run_reads_its_per_layer_metrics(name):
    result = execute(name, trace=1)
    assert result['correct'], result['check']
    assert result['metrics'], 'no per-layer metric was read'
    assert result['device']['window_s'] > 0


@pytest.mark.parametrize('name,fault', [
    (n, f) for n in SERVE
    for f in ('half_batch', 'altered', 'box_scale', 'no_mean')] + [
    (n, f) for n in TRAIN for f in ('unchanged', 'half_batch', 'boxes')])
def test_broken_timed_path_is_not_correct(name, fault):
    result = execute(name, fault=fault)
    assert result is not None
    assert not result['correct'], result['check']


@pytest.mark.parametrize('name', SERVE)
def test_serve_control_is_not_correct(name):
    from bench_port.harness import check_serve, serve
    w, config, traffic = tiny(name)
    limits = run.load_json(BENCH, 'checks', f'{name}.json')['numbers']
    det = traffic['detection']
    dev = torch.device('cpu')
    batches = serve.inputs(traffic, config, SEED, dev)
    net = serve.reference_net(config, SEED, dev, batches[0])
    readings = []
    for canvases in batches:
        dets = calibrate.control_dets(net, config, traffic, canvases, dev)
        readings.append(check_serve.compare(
            serve.reference_pool(net, config, canvases, dev), dets,
            det['confidence_threshold'], det['nms_threshold'],
            det['max_boxes']))
    worst = check_serve.worst(readings)
    assert any(worst[k] > limits[k] for k in limits), worst


@pytest.mark.parametrize('name', TRAIN)
def test_train_control_is_not_correct(name):
    # float8's departure grows with the canvas: its first loss reads
    # 0.0017 at 64x64 and 128x128 (under the limit), 0.0030 at 256x256
    w, config, traffic = tiny(name, train_hw=256, train_batch=8)
    limits = run.load_json(BENCH, 'checks', f'{name}.json')['numbers']
    cell = {'config': config, 'traffic': traffic,
            'device': torch.device('cpu')}
    torch.set_num_threads(4)
    out = calibrate.train_readings(cell, [], [SEED], 1.0, faults=False)
    worst = out['control'][SEED]
    assert any(worst[k] > limits[k] for k in limits), worst


def test_a_run_loads_no_jax():
    code = ('import sys, json; sys.path.insert(0, %r)\n'
            'sys.argv = ["x"]\n'
            'from bench_port.tests import test_bench_port_loops as t\n'
            'r = t.execute(%r)\n'
            'print(json.dumps(r is not None))\n' % (ROOT, SERVE[0]))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == 'true'


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CELLS))
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: run with -m cuda on the card')
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, 'run.py'), '--workload', name,
         '--seed', str(SEED), '--seconds', '3', '--trace', '0'],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])['correct']
