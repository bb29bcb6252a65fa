#!/usr/bin/env python3
"""The benchmark of ``multigriddet_tpu_torch`` on NVIDIA GPUs.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell is looked up by name in
``BENCHMARK.json``; it names a configuration (``bench_port/configs/
<config>.json``) and a traffic mix (``bench_port/traffic/<mix>.json``),
whose ``loop`` names the module of ``bench_port/harness`` that drives it.
The loop loads, warms up, measures for ``--seconds`` and checks what the
window produced against the plain reference (limits in
``bench_port/checks/<cell>.json``).  With ``--trace 0`` the last line of
standard output is a JSON object with the cell's end-to-end metrics;
with ``--trace 1`` a traced stretch follows the window and the line holds
the per-layer metrics, each read by ``bench_port/metrics/<metric>.py``.
The numbers compared, each beside its limit, end standard error and the
result line.  Exits non-zero with no result line when CUDA or the cards
the cell asks for are missing, or when JAX or the JAX package was
loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, 'bench_port')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'multigriddet_tpu')


class Cell:
    """What a loop module is handed: the cell's files, seed, window."""

    def __init__(self, args, workload, config, traffic, device):
        self.name, self.seed = workload['name'], int(args.seed)
        self.seconds, self.trace = float(args.seconds), bool(args.trace)
        self.config, self.traffic, self.device = config, traffic, device
        self.t0 = T0

    def mark(self, phase: str) -> None:
        """Print the seconds since the process started, after ``phase``
        of set-up (standard error)."""
        print(f'[setup] {phase} {time.perf_counter() - T0:.3f} s',
              file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def read_metric(name, run):
    path = os.path.join(BENCH, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'bench_port_metric_{len(run["read"])}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    run['read'].append(name)
    return mod.read(run)


def applies(metric, cell_name):
    return 'workloads' not in metric or cell_name in metric['workloads']


def execute(args, workload, bench, device, config=None, traffic=None,
            fault=None):
    """Run the cell's loop on ``device`` and assemble the result line;
    None when JAX or the JAX package was loaded.  ``config``, ``traffic``
    and ``fault`` replace the cell's files and plant a fault: the
    harness's own tests use them, the benchmark never does."""
    import torch
    config = config or load_json(BENCH, 'configs',
                                 f'{workload["config"]}.json')
    traffic = traffic or load_json(BENCH, 'traffic',
                                   f'{workload["traffic"]}.json')
    limits = load_json(BENCH, 'checks', f'{workload["name"]}.json')
    cell = Cell(args, workload, config, traffic, device)
    loop = importlib.import_module(f'bench_port.harness.{traffic["loop"]}')
    out = loop.run(cell, fault) if fault else loop.run(cell)

    found = forbidden_modules()
    if found:
        print(f'modules of JAX or the JAX package were loaded: {found}',
              file=sys.stderr)
        return None

    counts = {name[:-5]: load_json(BENCH, 'counts', name)
              for name in sorted(os.listdir(os.path.join(BENCH, 'counts')))
              if name.endswith('.json')}
    run = {'data': out['data'], 'config': workload['config'],
           'counts': counts, 'read': []}
    metrics = {}
    if args.trace:
        reported = {m['name'] for m in bench['end_to_end']
                    if applies(m, cell.name)}
        for m in bench['per_layer']:
            if applies(m, cell.name) and m['moves'] in reported:
                value = read_metric(m['name'], run)
                if value is not None:
                    metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        for m in bench['end_to_end']:
            if applies(m, cell.name):
                value, _ = out['e2e'][m['name']]
                metrics[m['name']] = {'value': value, 'unit': m['unit']}

    on_card = device.type == 'cuda'
    device_info = {'platform': 'gpu' if on_card else device.type,
                   'kind': (torch.cuda.get_device_name(device) if on_card
                            else 'cpu'),
                   'count': int(workload['chips']),
                   'memory_peak_bytes': int(out['memory_peak_bytes']),
                   'power_limit': power_limit() if on_card else None}
    result = {'correct': None, 'attempted': out['attempted'],
              'failed': out['failed'], 'metrics': metrics,
              'device': device_info}
    if args.trace:
        tr = out['data']['trace']
        device_info['busy_s'] = tr['busy_s']
        device_info['window_s'] = tr['wall_s']
        result['breakdown'] = {'device_ops': tr['device_ops'],
                               'idle_gaps': tr['idle_gaps']}
    checked = {k: {'value': out['check'][k], 'limit': v}
               for k, v in limits['numbers'].items()}
    result['correct'] = bool(out['failed'] == 0 and all(
        c['value'] <= c['limit'] for c in checked.values()))
    result['check'] = checked
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    build = os.path.join(ROOT, 'build')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['TORCHINDUCTOR_CACHE_DIR'] = os.path.join(build, 'inductor')
    sys.path.insert(0, ROOT)

    bench = load_json(ROOT, 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if args.workload not in cells:
        print(f'no workload {args.workload!r} in BENCHMARK.json',
              file=sys.stderr)
        return 2
    workload = cells[args.workload]

    import torch
    if not torch.cuda.is_available():
        print('CUDA is not available: the benchmark measures the card',
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(workload['chips']):
        print(f'the cell asks for {workload["chips"]} cards, '
              f'{torch.cuda.device_count()} present', file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)

    result = execute(args, workload, bench, device)
    if result is None:
        return 4
    for k, c in result['check'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
