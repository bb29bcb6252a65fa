"""Training CLI of the port: ``python -m multigriddet_tpu_torch.train``.

The same flags and overrides as the repo's ``train.py`` (``--config``,
``--weights``, ``--backbone-weights``, ``--resume``, ``--epochs``,
``--batch-size``, ``--learning-rate``, ``--input-shape``), plus
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch path).
Writes ``history.jsonl``, checkpoints and ``final_model.msgpack``.
"""

from __future__ import annotations

import argparse
import sys

from .config import load_config
from .training import MultiGridTrainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train MultiGridDet '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--config', default='configs/train_config.yaml',
                   help='training YAML config')
    p.add_argument('--weights', default=None,
                   help='full-model weights to fine-tune from (.msgpack)')
    p.add_argument('--backbone-weights', default=None,
                   help='backbone-only weights (.msgpack)')
    p.add_argument('--resume', action='store_true',
                   help='resume from the latest checkpoint')
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--learning-rate', type=float, default=None)
    p.add_argument('--input-shape', type=int, nargs=2, default=None,
                   metavar=('H', 'W'))
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def apply_overrides(config, args):
    training = config.setdefault('training', {})
    if args.epochs is not None:
        training['epochs'] = args.epochs
    if args.batch_size is not None:
        training['batch_size'] = args.batch_size
    if args.learning_rate is not None:
        training['learning_rate'] = args.learning_rate
    resume = config.setdefault('resume', {})
    if args.weights:
        # weights load when the model is built; resume.enabled gates only
        # the checkpoint restore
        resume['weights_path'] = args.weights
    if args.backbone_weights:
        resume['backbone_weights_path'] = args.backbone_weights
    if args.resume:
        resume['enabled'] = True
    if args.input_shape:
        config.setdefault('model', {}).setdefault('preset', {})[
            'input_shape'] = [*args.input_shape, 3]
    return config


def main(argv=None):
    args = parse_args(argv)
    config = apply_overrides(load_config(args.config, config_type='train'),
                             args)
    trainer = MultiGridTrainer(config, device=args.device)
    try:
        trainer.train()
    except KeyboardInterrupt:
        print('\nTraining interrupted by user.')
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
