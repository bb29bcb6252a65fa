"""``python -m multigriddet_tpu_torch.validate MODE``: the learning
validations of ``tools/validate_*.py`` on the port.

Modes:

* ``learning``: ``multigriddet_tiny`` overfits 16 images for 600 epochs;
  passes when mAP50 > 0.95 (``tools/validate_learning.py``).
* ``flagship [--ema]``: ``multigriddet_darknet`` in bfloat16 on the
  200-image shapes set for 120 epochs with mosaic, flips and zoom; with
  ``--ema`` the EMA weights (0.999) are scored beside the raw ones
  (``tools/validate_flagship.py``; it has no pass line).
* ``presets [csp panet resnet mobile multi_anchor]``: each preset for 60
  epochs on the same set (default: all but the opt-in ``multi_anchor``,
  csp trained on multi-anchor-assigned targets); passes when every mAP50
  > 0.7 (``tools/validate_presets.py``).
* ``anchors``: the flagship with 3 anchors a level on the 3-band x
  3-aspect set (``tools/validate_anchor_prediction.py``; no pass line).

Each run prints mAP50, mAP, the final loss, epochs, seconds and images a
second (the anchor mode also the anchor loss).  Every mode but
``learning`` warms up for 3 epochs, as the tools do, so ``--epochs``
must be at least 4 there.  ``--nms-backend`` scores
through ``xla`` (the tools' default), ``pallas`` or ``pallas_fused``; on
the card the weights are also scored through ``pallas_fused``, the
pop-max kernel.  ``--device`` is ``cuda`` unless ``cpu`` is asked for.
The sets are written under ``--root`` (default: a temporary directory,
removed at the end); ``--report`` writes the results as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
from typing import Dict, List, Optional

from . import runner

MODES = ('learning', 'flagship', 'presets', 'anchors')


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m multigriddet_tpu_torch.validate',
        description=__doc__.splitlines()[0])
    p.add_argument('mode', choices=MODES)
    p.add_argument('presets', nargs='*', metavar='PRESET',
                   help='presets mode: any of ' +
                        ', '.join(runner.PRESET_MODELS))
    p.add_argument('--ema', action='store_true',
                   help='flagship mode: also score the EMA weights')
    p.add_argument('--epochs', type=int, default=None,
                   help="override the tool's epoch count")
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    p.add_argument('--nms-backend', default='xla',
                   choices=['xla', 'pallas', 'pallas_fused'])
    p.add_argument('--root', default=None,
                   help='where the synthetic set is written (default: a '
                        'temporary directory, removed at the end)')
    p.add_argument('--report', default=None,
                   help='write the results as JSON to this file')
    args = p.parse_args(argv)
    if args.presets and args.mode != 'presets':
        p.error(f'{args.mode} takes no preset names')
    unknown = [k for k in args.presets if k not in runner.PRESET_MODELS]
    if unknown:
        p.error(f'unknown presets {unknown}; choose from '
                f'{list(runner.PRESET_MODELS)}')
    if args.ema and args.mode != 'flagship':
        p.error('--ema applies to the flagship mode')
    if (args.epochs is not None and args.mode != 'learning'
            and args.epochs < runner.MIN_SCHEDULED_EPOCHS):
        p.error(f'{args.mode} warms up for {runner.WARMUP_EPOCHS} epochs, '
                f'so --epochs must be at least '
                f'{runner.MIN_SCHEDULED_EPOCHS}')
    return args


def tasks(mode: str, presets=(), epochs: Optional[int] = None
          ) -> List[runner.Task]:
    """The tasks a mode runs, in order."""
    if mode == 'presets':
        chosen = [runner.PRESETS[k]
                  for k in (presets or runner.DEFAULT_PRESETS)]
    else:
        chosen = [{'learning': runner.LEARNING,
                   'flagship': runner.FLAGSHIP,
                   'anchors': runner.ANCHORS}[mode]]
    if epochs is not None:
        chosen = [dataclasses.replace(t, epochs=epochs)
                  for t in chosen]
    return chosen


def passes(mode: str, results: List[Dict]) -> Optional[bool]:
    """The tool's pass line on the results' mAP50, or None where the tool
    has none (flagship, anchors)."""
    if mode == 'learning':
        return results[0]['mAP50'] > runner.LEARNING.pass_map50
    if mode == 'presets':
        return all(r['mAP50'] > runner.PRESETS[r['task']].pass_map50
                   for r in results)
    return None


def main(argv=None) -> int:
    args = parse_args(argv)
    chosen = tasks(args.mode, args.presets, args.epochs)
    root = args.root or tempfile.mkdtemp(prefix=f'mgd_{args.mode}_')
    results, anns = [], {}
    try:
        for task in chosen:
            if task.dataset not in anns:
                anns[task.dataset] = runner.write_set(
                    task, os.path.join(root, task.dataset))
            results.append(runner.run(
                task, anns[task.dataset], args.device, args.nms_backend,
                ema=args.ema).result)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    if len(results) > 1:
        print('\nSummary:')
        for r in results:
            print(f'  {r["task"]} ({r["model"]}): mAP50={r["mAP50"]:.3f}')
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, 'w') as f:
            json.dump({'mode': args.mode, 'results': results}, f, indent=1)
    verdict = passes(args.mode, results)
    if verdict is None:
        return 0
    print(f'{args.mode} validation {"PASSED" if verdict else "FAILED"} '
          f'(mAP50 > {chosen[0].pass_map50} for every run)')
    return 0 if verdict else 1


if __name__ == '__main__':
    sys.exit(main())
