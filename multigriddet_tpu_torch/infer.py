"""Inference CLI of the port: ``python -m multigriddet_tpu_torch.infer``.

The same flags as the repo's ``infer.py`` (``--config``, ``--weights``,
``--input``, ``--type``, ``--conf``, ``--nms``, ``--nms-method``,
``--output``, ``--no-save``, ``--no-show``), plus ``--device`` (``cuda``
by default; ``cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import load_config
from .inference import MultiGridInference


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Run MultiGridDet inference '
                                            '(PyTorch/CUDA port)')
    p.add_argument('--config', default='configs/infer_config.yaml')
    p.add_argument('--weights', default=None, help='.msgpack weights')
    p.add_argument('--input', default=None,
                   help='image path or directory')
    p.add_argument('--type', default=None,
                   choices=['image', 'video', 'camera', 'directory'])
    p.add_argument('--conf', type=float, default=None,
                   help='confidence threshold')
    p.add_argument('--nms', type=float, default=None, help='NMS threshold')
    p.add_argument('--nms-method', default=None,
                   choices=['standard', 'diou', 'soft', 'cluster'])
    p.add_argument('--output', default=None, help='output directory')
    p.add_argument('--no-save', action='store_true',
                   help='do not save output')
    p.add_argument('--no-show', action='store_true',
                   help='do not show output')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p.parse_args(argv)


def apply_overrides(config, args):
    if args.weights:
        config['weights_path'] = args.weights
    inp = config.setdefault('input', {})
    if args.input is not None:
        inp['source'] = args.input
        if args.type is None:
            s = str(args.input).lower()
            if s.isdigit():
                inp['type'] = 'camera'
            elif os.path.isdir(args.input):
                inp['type'] = 'directory'
            elif s.endswith(('.mp4', '.avi', '.mov', '.mkv', '.webm')):
                inp['type'] = 'video'
            else:
                inp['type'] = 'image'
    if args.type is not None:
        inp['type'] = args.type
    det = config.setdefault('detection', {})
    if args.conf is not None:
        det['confidence_threshold'] = args.conf
    if args.nms is not None:
        det['nms_threshold'] = args.nms
    if args.nms_method is not None:
        det['nms_method'] = args.nms_method
    if args.output is not None:
        config.setdefault('output', {})['output_dir'] = args.output
        config['output']['save_result'] = True
    if args.no_save:
        config.setdefault('output', {})['save_result'] = False
    if args.no_show:
        config.setdefault('output', {})['show_result'] = False
    return config


def main(argv=None):
    args = parse_args(argv)
    config = apply_overrides(load_config(args.config, config_type='infer'),
                             args)
    engine = MultiGridInference(config, device=args.device)
    try:
        engine.run()
    except KeyboardInterrupt:
        print('\nInterrupted by user.')
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
