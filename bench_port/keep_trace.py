#!/usr/bin/env python3
"""A ``--trace 1`` run of the benchmark that keeps its trace.

    python3 bench_port/keep_trace.py --workload <cell> --seed <n>
        --seconds <s>

Runs the cell as ``bench_port/run.py --trace 1`` does and prints the
same result line, last on standard output.  Then it writes the traced
stretch's Chrome / Perfetto trace, gzipped, to
``build/traces/<cell>.<seed>.json.gz`` and prints its path on standard
error, followed by one line ``spans <JSON>``: the benchmark's and the
program's spans a unit of the stretch, the share of each benchmark span
its program spans cover, and the calls that block the host on the
device (``harness/program_spans.read``).  Run from the root of a
checkout.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    import torch.profiler

    from bench_port import run
    from bench_port.harness import program_spans

    kept = []

    class Kept(torch.profiler.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    args, _ = p.parse_known_args(argv)
    torch.profiler.profile = Kept
    rc = run.main(argv + ['--trace', '1'])
    if rc or not kept:
        return rc or 5
    out = os.path.join(ROOT, 'build', 'traces')
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f'{args.workload}.{args.seed}.json.gz')
    prof = kept[-1]
    prof.export_chrome_trace(path)
    print(f'trace {path}', file=sys.stderr)
    print('spans ' + json.dumps(program_spans.read(prof.events())),
          file=sys.stderr, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
