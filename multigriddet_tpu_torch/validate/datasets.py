"""The synthetic datasets of the learning validations.

Each function writes one set exactly as the JAX package's tool does: the
same ``numpy.random.RandomState`` seed and draw order, the same Pillow
primitives, JPEG quality 95, and annotation lines ``path x1,y1,x2,y2,cls
...`` in an ``ann.txt`` under ``root``.  With the same Pillow the JPEG
bytes come out identical.

* :func:`shapes`: 200 images of 256x256 with 1-3 shapes of 4 classes
  (rectangle, ellipse, triangle, cross), ``RandomState(0)``
  (``tools/validate_presets.py`` ``make_dataset``, the same loop as
  ``tools/validate_flagship.py``).
* :func:`boxes`: 16 images of 128x128, one red or green box each
  (``tools/validate_learning.py`` ``make_dataset``).
* :func:`anchor_bands`: up to 200 images of 256x256 with 1-2 objects in 3
  size bands x 3 aspects, ``RandomState(1)``; a draw left with no object
  writes no image (``tools/validate_anchor_prediction.py``).

Pillow is imported when a set is written.
"""

from __future__ import annotations

import os

import numpy as np

SHAPES = ['rect', 'ellipse', 'tri', 'cross']
COLORS = [(230, 40, 40), (40, 230, 40), (60, 60, 230), (230, 230, 40)]


def _write_ann(root: str, lines) -> str:
    ann = f'{root}/ann.txt'
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def shapes(root: str) -> str:
    """The 4-class shapes set of the flagship and preset validations;
    returns the annotation file."""
    from PIL import Image, ImageDraw
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(200):
        img = Image.new('RGB', (256, 256), tuple(rng.randint(0, 50, 3)))
        d = ImageDraw.Draw(img)
        toks = []
        for _ in range(rng.randint(1, 4)):
            cls = rng.randint(0, 4)
            w, h = rng.randint(40, 110), rng.randint(40, 110)
            x1, y1 = rng.randint(0, 256 - w), rng.randint(0, 256 - h)
            col = COLORS[cls]
            if SHAPES[cls] == 'rect':
                d.rectangle([x1, y1, x1 + w, y1 + h], fill=col)
            elif SHAPES[cls] == 'ellipse':
                d.ellipse([x1, y1, x1 + w, y1 + h], fill=col)
            elif SHAPES[cls] == 'tri':
                d.polygon([(x1 + w // 2, y1), (x1, y1 + h),
                           (x1 + w, y1 + h)], fill=col)
            else:
                d.rectangle([x1 + w // 3, y1, x1 + 2 * w // 3, y1 + h],
                            fill=col)
                d.rectangle([x1, y1 + h // 3, x1 + w, y1 + 2 * h // 3],
                            fill=col)
            toks.append(f'{x1},{y1},{x1+w},{y1+h},{cls}')
        p = f'{root}/i{i}.jpg'
        img.save(p, quality=95)
        lines.append(p + ' ' + ' '.join(toks))
    return _write_ann(root, lines)


def boxes(root: str) -> str:
    """The 2-class overfit set of the learning validation; returns the
    annotation file."""
    from PIL import Image, ImageDraw
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(16):
        img = Image.new('RGB', (128, 128), (rng.randint(0, 60),) * 3)
        d = ImageDraw.Draw(img)
        x1, y1 = rng.randint(5, 60), rng.randint(5, 60)
        w, h = rng.randint(30, 60), rng.randint(30, 60)
        cls = i % 2
        color = (230, 30, 30) if cls == 0 else (30, 230, 30)
        d.rectangle([x1, y1, x1 + w, y1 + h], fill=color)
        p = os.path.join(root, f'img_{i}.jpg')
        img.save(p, quality=95)
        lines.append(f'{p} {x1},{y1},{x1 + w},{y1 + h},{cls}')
    return _write_ann(root, lines)


def anchor_bands(root: str) -> str:
    """The 2-class set of the anchor-prediction validation, whose objects
    take one of three aspects in each of three size bands; returns the
    annotation file."""
    from PIL import Image, ImageDraw
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(1)
    lines = []
    for i in range(200):
        img = Image.new('RGB', (256, 256), tuple(rng.randint(0, 50, 3)))
        d = ImageDraw.Draw(img)
        toks = []
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(0, 2)
            band = rng.randint(0, 3)            # size band -> layer
            base = [96, 56, 28][band]
            ar = rng.choice([0.5, 1.0, 2.0])    # aspect -> anchor
            w = int(base * np.sqrt(ar))
            h = int(base / np.sqrt(ar))
            w, h = max(w, 12), max(h, 12)
            if w >= 250 or h >= 250:
                continue
            x1, y1 = rng.randint(0, 256 - w), rng.randint(0, 256 - h)
            col = (230, 40, 40) if cls == 0 else (40, 230, 40)
            if cls == 0:
                d.rectangle([x1, y1, x1 + w, y1 + h], fill=col)
            else:
                d.ellipse([x1, y1, x1 + w, y1 + h], fill=col)
            toks.append(f'{x1},{y1},{x1+w},{y1+h},{cls}')
        if not toks:
            continue
        p = f'{root}/i{i}.jpg'
        img.save(p, quality=95)
        lines.append(p + ' ' + ' '.join(toks))
    return _write_ann(root, lines)


SETS = {'shapes': shapes, 'boxes': boxes, 'anchor_bands': anchor_bands}
