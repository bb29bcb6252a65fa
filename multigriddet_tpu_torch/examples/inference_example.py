"""Python-API inference example (counterpart of the repo's
``examples/inference_example.py``).

    python -m multigriddet_tpu_torch.examples.inference_example \\
        [image] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('image', nargs='?', default='examples/images/dog.jpg')
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = p.parse_args(argv)

    from PIL import Image

    from ..config import load_config
    from ..inference import MultiGridInference

    config = load_config('configs/infer_config.yaml', config_type='infer')
    engine = MultiGridInference(config, device=args.device)
    with Image.open(args.image) as image:
        boxes, classes, scores = engine.detect(image)
    for box, cls, score in zip(boxes, classes, scores):
        name = engine.class_names[int(cls)]
        x, y, w, h = box
        print(f'{name:>16} {score:.3f}  [{x:.0f}, {y:.0f}, {w:.0f}x{h:.0f}]')
    return 0


if __name__ == '__main__':
    sys.exit(main())
