"""Evaluation CLI of the port: ``python -m multigriddet_tpu_torch.eval``.

The same flags as the repo's ``eval.py`` (``--config``, ``--weights``,
``--data``, ``--batch-size``, ``--conf``, ``--max-images``), plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch path).
Prints the mAP table and the phase times; with ``visualizations.enabled``
it also writes the report plots.
"""

from __future__ import annotations

import argparse
import sys

from .config import load_config
from .evaluation import MultiGridEvaluator, generate_evaluation_report


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Evaluate MultiGridDet (mAP) '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--config', default='configs/eval_config.yaml')
    p.add_argument('--weights', default=None, help='.msgpack weights')
    p.add_argument('--data', default=None, help='annotation txt')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--conf', type=float, default=None)
    p.add_argument('--max-images', type=int, default=None)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def apply_overrides(config, args):
    if args.weights:
        config['weights_path'] = args.weights
    if args.data:
        config.setdefault('data', {})['annotation'] = args.data
    ev = config.setdefault('evaluation', {})
    if args.batch_size is not None:
        ev['batch_size'] = args.batch_size
    if args.conf is not None:
        ev['confidence_threshold'] = args.conf
    if args.max_images is not None:
        ev['max_images'] = args.max_images
    return config


def main(argv=None):
    args = parse_args(argv)
    config = apply_overrides(load_config(args.config, config_type='eval'),
                             args)
    evaluator = MultiGridEvaluator(config, device=args.device)
    try:
        results = evaluator.evaluate()
        evaluator.print_results()
        viz_cfg = config.get('visualizations', {}) or {}
        if viz_cfg.get('enabled'):
            produced = generate_evaluation_report(
                results, evaluator.predictions, evaluator.ground_truths,
                evaluator.class_names, viz_cfg)
            for name, path in produced.items():
                print(f'  plot: {name} -> {path}')
    except KeyboardInterrupt:
        print('\nInterrupted by user.')
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
