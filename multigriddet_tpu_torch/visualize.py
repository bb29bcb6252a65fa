"""Debug overlays of the input pipeline: ``python -m
multigriddet_tpu_torch.visualize {y_true,augmented}``.

* ``y_true`` (``tools/visualize_y_true.py``): runs the generator on the
  first ``--num`` annotation lines, decodes every assigned cell of every
  scale of the encoded targets back to a box, and writes
  ``ytrue_<i>.png`` with the decoded targets in their class colours and
  the annotation boxes in white, so the 9-cell encoding can be inspected.
* ``augmented`` (``tools/visualize_augmented_batches.py``): runs the
  augmenting generator (mosaic, mixup, GridMask and the rest of the
  chain) over the shuffled lines and writes ``batch<b>_img<i>.png`` with
  the surviving boxes drawn.

Usage::

    python -m multigriddet_tpu_torch.visualize y_true --annotation data/val.txt \\
        --classes configs/coco_classes.txt --out /tmp/ytrue --num 4
    python -m multigriddet_tpu_torch.visualize augmented \\
        --annotation data/val.txt --classes configs/coco_classes.txt \\
        --out /tmp/augviz --batches 2

The tools' flags and defaults, plus ``--device`` (``cuda`` by default: the
images are decoded and augmented on the card's device stage; ``cpu`` runs
the plain PyTorch path).  Drawing uses ``utils/visualization.py``;
writing the PNGs needs Pillow.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def decode_y_true_layer(y_true: np.ndarray, anchors: np.ndarray, input_hw):
    """All assigned cells of one scale ``[gh, gw, 5 + A + C]`` ->
    ``(boxes [K, 4] top-left xywh, classes [K])`` in canvas pixels."""
    gh, gw, _ = y_true.shape
    na = len(anchors)
    js, is_ = np.where(y_true[..., 4] > 0.5)
    boxes, classes = [], []
    sh, sw = input_hw[0] / gh, input_hw[1] / gw
    for j, i in zip(js, is_):
        cell = y_true[j, i]
        cx = (cell[0] + i) * sw
        cy = (cell[1] + j) * sh
        anchor = anchors[int(np.argmax(cell[5:5 + na]))]
        w, h = np.exp(cell[2:4]) * anchor
        boxes.append([cx - w / 2, cy - h / 2, w, h])
        classes.append(int(np.argmax(cell[5 + na:])))
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32))


def _xywh(boxes: np.ndarray):
    """Valid x1y1x2y2cls rows -> (top-left xywh, classes)."""
    valid = (boxes[:, 2] - boxes[:, 0]) > 0
    xywh = np.stack([boxes[valid, 0], boxes[valid, 1],
                     boxes[valid, 2] - boxes[valid, 0],
                     boxes[valid, 3] - boxes[valid, 1]], -1)
    return xywh, boxes[valid, 4].astype(int)


def _save(img: np.ndarray, path: str):
    from PIL import Image
    Image.fromarray(img).save(path)


def y_true_overlays(args):
    """The overlays of ``y_true`` mode, as ``[(path, uint8 image)]``."""
    from .data import MultiGridDataGenerator, load_annotation_lines
    from .utils import load_anchors, load_classes
    from .utils.visualization import draw_boxes, get_colors
    lines = load_annotation_lines(args.annotation, shuffle=False)[:args.num]
    class_names = load_classes(args.classes)
    anchors = load_anchors(args.anchors)
    hw = (args.input_size, args.input_size)
    gen = MultiGridDataGenerator(
        lines, anchors, len(class_names), hw, batch_size=len(lines),
        augment={'enabled': args.augment, 'mosaic_prob': 0.0,
                 'mixup_prob': 0.0},
        train=args.augment, drop_remainder=False, device=args.device)
    try:
        images, y_true, aug_boxes = next(iter(gen))
    finally:
        gen.close()
    images = images.cpu().numpy()
    y_true = [yt.cpu().numpy() for yt in y_true]
    aug_boxes = aug_boxes.cpu().numpy()
    colors = get_colors(len(class_names))
    out = []
    for b in range(images.shape[0]):
        img = (images[b] * 255).astype(np.uint8)
        for layer, yt in enumerate(y_true):
            boxes, classes = decode_y_true_layer(yt[b], anchors[layer], hw)
            if len(boxes):
                img = draw_boxes(img, boxes, classes, np.ones(len(boxes)),
                                 class_names, colors, show_scores=False)
        # the annotation boxes in white
        ann, cls = _xywh(aug_boxes[b])
        img = draw_boxes(img, ann, cls, np.ones(len(ann)), class_names,
                         [(255, 255, 255)] * len(class_names),
                         show_scores=False)
        out.append((os.path.join(args.out, f'ytrue_{b}.png'), img))
    return out


def augmented_overlays(args):
    """The overlays of ``augmented`` mode, as ``[(path, uint8 image,
    boxes kept)]``."""
    from .data import MultiGridDataGenerator, load_annotation_lines
    from .utils import load_anchors, load_classes
    from .utils.visualization import draw_boxes, get_colors
    lines = load_annotation_lines(args.annotation, shuffle=True, seed=0)
    class_names = load_classes(args.classes)
    anchors = load_anchors(args.anchors)
    gen = MultiGridDataGenerator(
        lines, anchors, len(class_names),
        (args.input_size, args.input_size), args.batch_size,
        augment={'enabled': True, 'mosaic_prob': args.mosaic,
                 'mixup_prob': args.mixup, 'enhance_type': 'gridmask'},
        train=True, device=args.device)
    colors = get_colors(len(class_names))
    out = []
    try:
        for bi, (images, _, boxes) in enumerate(gen):
            if bi >= args.batches:
                break
            images = images.cpu().numpy()
            boxes = boxes.cpu().numpy()
            for i in range(images.shape[0]):
                img = (images[i] * 255).astype(np.uint8)
                xywh, cls = _xywh(boxes[i])
                img = draw_boxes(img, xywh, cls, np.ones(len(xywh)),
                                 class_names, colors, show_scores=False)
                out.append((os.path.join(args.out,
                                         f'batch{bi}_img{i}.png'),
                            img, len(xywh)))
    finally:
        gen.close()
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog='python -m multigriddet_tpu_torch.visualize',
        description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest='mode', required=True)
    yt = sub.add_parser('y_true', help='decoded encoder targets')
    aug = sub.add_parser('augmented', help='augmented batches')
    for q in (yt, aug):
        q.add_argument('--annotation', required=True)
        q.add_argument('--classes', required=True)
        q.add_argument('--anchors', default=None)
        q.add_argument('--input-size', type=int, default=416)
        q.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    yt.add_argument('--num', type=int, default=4)
    yt.add_argument('--augment', action='store_true')
    yt.add_argument('--out', default='output/ytrue_viz')
    aug.add_argument('--batch-size', type=int, default=4)
    aug.add_argument('--batches', type=int, default=2)
    aug.add_argument('--mosaic', type=float, default=0.5)
    aug.add_argument('--mixup', type=float, default=0.25)
    aug.add_argument('--out', default='output/aug_viz')
    return p.parse_args(argv)


def main(argv=None) -> int:
    from .device import resolve_device
    args = parse_args(argv)
    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.mode == 'y_true':
        for path, img in y_true_overlays(args):
            _save(img, path)
            print(f'wrote {path}')
    else:
        for path, img, n in augmented_overlays(args):
            _save(img, path)
            print(f'wrote {path} ({n} boxes)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
