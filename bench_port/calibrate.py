#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 ...
        --control-seeds 7 8 9 [--seconds 2] [--report PATH]

For a serve cell, in one process: for each ``--seeds`` seed the
program's closed loop runs a short window at the cell's own batch, depth
and settings, and the cell's check compares a seeded sample of what it
produced, as ``run.py`` does; for each ``--control-seeds`` seed the
control does the same with the plain reference computed in float8
(e4m3, one scale per tensor, on every convolution's input and weight) in
the program's place.  For a train cell: the whole run of each seed (a
short window), the control (the reference's steps in float8, the
gradient passed straight through the rounding) against the float32
reference, and each planted fault of ``harness/check_train.py`` on the
control seeds.  The lower reading of each number is the largest of
the program's seeds, the upper the smallest of the control's
(``PERF.md`` gives both and the limit set between them).  A serve cell
also runs the program with each planted fault of ``harness/serve.py`` on
the control seeds.  Prints one JSON
object; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fp8(x):
    """Round to float8 e4m3 with one scale per tensor, back to float32."""
    import torch
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def fp8_ste(x):
    """:func:`fp8` in the forward, the identity in the backward."""
    return x + (fp8(x) - x).detach()


def control_dets(net, config, traffic, canvases, dev):
    """The control's detections: the reference in float8, decoded and
    passed through the reference greedy NMS."""
    import torch

    from bench_port.harness.serve import reference_pool
    from bench_port.reference.detect import popmax_nms
    det = traffic['detection']
    net.quant = fp8
    try:
        ref = reference_pool(net, config, canvases, dev)
    finally:
        net.quant = None
    b, c, s, v, _ = popmax_nms(ref['boxes'], ref['scores'], ref['classes'],
                               det['confidence_threshold'],
                               det['nms_threshold'], det['max_boxes'])
    return tuple(t.cpu().numpy() for t in (b, c.to(torch.int32), s, v))


def serve_readings(cell, seeds, control_seeds, seconds):
    import numpy as np
    import torch

    from bench_port.harness import check_serve, device, serve, trace, weights
    from multigriddet_tpu_torch.inference import MultiGridInference
    config, traffic, dev = cell['config'], cell['traffic'], cell['device']
    det = traffic['detection']

    def numbers(net, batches, pairs, seed):
        """The check over a seeded sample of ``pairs`` (input index,
        detections or a call that makes them), as a run draws it."""
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(pairs), size=min(traffic['check_batches'],
                                               len(pairs)), replace=False)
        readings = []
        for i in sorted(pick):
            k, dets = pairs[i]
            readings.append(check_serve.compare(
                serve.reference_pool(net, config, batches[k], dev),
                dets() if callable(dets) else dets,
                det['confidence_threshold'], det['nms_threshold'],
                det['max_boxes']))
        return check_serve.worst(readings)

    net = serve.reference_net(config, seeds[0], dev,
                              serve.inputs(traffic, config, seeds[0],
                                           dev)[0])
    with serve.anchors_file(config) as path:
        engine = MultiGridInference(
            serve.engine_config(config, traffic, path), device=dev)

    def program(seed, fault=None):
        t0 = time.perf_counter()
        batches = serve.inputs(traffic, config, seed, dev)
        weights.fill(net, seed, dev)
        weights.calibrate(net, torch.as_tensor(batches[0]).to(dev), seed)
        weights.load_port(engine.model, net)
        loop = serve.Loop(engine, batches, traffic['pipeline_depth'],
                          trace.Spans(), fault)
        loop.count(2)
        loop.drain()
        done = loop.run(seconds) + loop.drain()
        device.sync(dev)
        out = numbers(net, batches, [(r['input'], r['dets']) for r in done],
                      seed)
        return dict(out, batches=len(done),
                    seconds=time.perf_counter() - t0)

    out = {'program': {}, 'control': {}, 'faults': {}}
    for seed in seeds:
        out['program'][seed] = program(seed)
        print(json.dumps({'seed': seed, **out['program'][seed]}),
              file=sys.stderr, flush=True)
    for fault in serve.FAULTS:
        out['faults'][fault] = {}
        for seed in control_seeds:
            out['faults'][fault][seed] = program(seed, fault)
            print(json.dumps({'fault': fault, 'seed': seed,
                              **out['faults'][fault][seed]}),
                  file=sys.stderr, flush=True)
    del engine
    device.empty_cache(dev)
    for seed in control_seeds:
        batches = serve.inputs(traffic, config, seed, dev)
        weights.fill(net, seed, dev)
        weights.calibrate(net, torch.as_tensor(batches[0]).to(dev), seed)
        out['control'][seed] = numbers(net, batches, [
            (k, lambda k=k: control_dets(net, config, traffic, batches[k],
                                         dev))
            for k in range(len(batches))], seed)
        print(json.dumps({'control_seed': seed, **out['control'][seed]}),
              file=sys.stderr, flush=True)
    names = check_serve.NUMBERS
    out['lower'] = {k: max(r[k] for r in out['program'].values())
                    for k in names}
    if out['control']:
        out['upper'] = {k: min(r[k] for r in out['control'].values())
                        for k in names}
    return out


def _cell(cell, seed, seconds):
    """A run's cell at ``seed`` with a window of ``seconds``."""
    import argparse

    from bench_port.run import Cell
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    out = Cell(args, {'name': 'calibrate'}, cell['config'], cell['traffic'],
               cell['device'])
    out.t0 = time.perf_counter()
    out.mark = lambda phase: None
    return out


def train_readings(cell, seeds, control_seeds, seconds, faults=True):
    import shutil
    import tempfile

    from bench_port.harness import check_train, train, weights
    from bench_port.reference.model import Net
    from bench_port.reference.train import replay
    from bench_port.harness.device import float32_exact
    config, traffic, dev = cell['config'], cell['traffic'], cell['device']
    out = {'program': {}, 'control': {}, 'faults': {}}
    for seed in seeds:
        t0 = time.perf_counter()
        r = train.run(_cell(cell, seed, seconds))
        out['program'][seed] = dict(r['check'], img_per_s=r['e2e'][
            'train_img_per_s'][0], seconds=time.perf_counter() - t0)
        print(json.dumps({'seed': seed, **out['program'][seed]}),
              file=sys.stderr, flush=True)
    for fault in (check_train.FAULTS if faults else ()):
        out['faults'][fault] = {}
        for seed in control_seeds:
            r = train.run(_cell(cell, seed, 0.5), fault=fault)
            out['faults'][fault][seed] = r['check']
            print(json.dumps({'fault': fault, 'seed': seed, **r['check']}),
                  file=sys.stderr, flush=True)
    for seed in control_seeds:
        root = tempfile.mkdtemp(prefix='bench_port_cal_')
        try:
            lines = train.write_dataset(traffic, seed, dev, root)
            net = Net(config['reference'],
                      [len(a) for a in config['anchors']],
                      config['num_classes'])
            weights.fill(net, seed, dev)
            start = [t.detach().clone() for t in net.trainables()]
            net.quant = fp8_ste
            net.checkpoint = True
            with float32_exact():
                ctl = replay.run(net, lines, check_train.seed32(seed),
                                 config, traffic, traffic['check_steps'],
                                 dev)
            names = [str(i) for i in range(len(start))]
            fresh = Net(config['reference'],
                        [len(a) for a in config['anchors']],
                        config['num_classes'])
            weights.fill(fresh, seed, dev)
            program = {'losses': ctl['losses'],
                       'grads': [g.cpu() for g in ctl['grads']],
                       'params': [p.cpu() for p in ctl['params']],
                       'stats': [t.cpu() for t in ctl['stats']]}
            out['control'][seed] = check_train.compare(
                fresh, start, names, program, lines, seed, config, traffic,
                dev)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({'control_seed': seed, **out['control'][seed]}),
              file=sys.stderr, flush=True)
    names = check_train.NUMBERS
    if out['program']:
        out['lower'] = {k: max(r[k] for r in out['program'].values())
                        for k in names}
    if out['control']:
        out['upper'] = {k: min(r[k] for r in out['control'].values())
                        for k in names}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--report', default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('CUDA is not available', file=sys.stderr)
        return 3
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        w = {c['name']: c for c in json.load(f)['workloads']}[args.workload]
    from bench_port.run import BENCH, load_json
    cell = {'config': load_json(BENCH, 'configs', f'{w["config"]}.json'),
            'traffic': load_json(BENCH, 'traffic', f'{w["traffic"]}.json'),
            'device': torch.device('cuda', 0)}
    if cell['traffic']['loop'] == 'train':
        out = train_readings(cell, args.seeds, args.control_seeds,
                             args.seconds)
    else:
        out = serve_readings(cell, args.seeds, args.control_seeds,
                             args.seconds)
    out['workload'] = args.workload
    out['card'] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            f.write(text)
    print(text)
    return 0


if __name__ == '__main__':
    sys.exit(main())
