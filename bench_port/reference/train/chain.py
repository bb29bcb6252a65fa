"""Frozen copy of the device stage of ``multigriddet_tpu_torch/data/
pipeline.py`` for the plain reference (imports rewritten; nothing of the
program is imported): the per-batch generator split, the augmentation
chain's draws in their slot order, the chain itself and the stage (u8 ->
float32, chain, /255, 9-cell encoding).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import augment as A
from .encoding import encode_targets
from .util import to_device
from .yuv import yuv420_to_rgb

# the chain's op slots in the order of the JAX stage's keys: split(key,
# 12) gives the first twelve, fold_in(key, 101..104) the last four
SLOTS = ('resize', 'hflip', 'brightness', 'contrast', 'saturation', 'hue',
         'grayscale', 'rotate90', 'gridmask', 'mosaic', 'mixup', 'blur',
         'sharpness', 'motion_blur', 'rotate_any', 'copypaste')


def calculate_expansion_factor(mosaic_prob: float, mixup_prob: float) -> int:
    """x8 mosaic+mixup, x4 mosaic, x2 mixup, x1 none."""
    factor = 1
    if mosaic_prob > 0:
        factor *= 4
    if mixup_prob > 0:
        factor *= 2
    return factor


def augmentation_enabled(aug_cfg: Optional[Dict], train: bool) -> bool:
    """Whether the device stage augments (the JAX package's rule: a train
    stage augments unless ``enabled`` is false)."""
    return bool(train and (aug_cfg or {}).get('enabled', True))


def pixels_to_f32(pixels) -> torch.Tensor:
    """Link-format pixels -> f32 RGB in [0, 255]: a bare u8 batch
    ``[B, H, W, 3]``, a 1-tuple of one, or planar yuv420
    ``(y [B, H, W], cb, cr [B, H/2, W/2])``."""
    if isinstance(pixels, (tuple, list)):
        if len(pixels) == 3:
            return yuv420_to_rgb(*pixels)
        pixels = pixels[0]
    return pixels.float()


def split_generator(generator: torch.Generator) -> torch.Generator:
    """A new generator seeded from ``generator``'s stream (the counterpart
    of ``jax.random.split``)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


def draw_chain(generator: torch.Generator, b: int, n: int,
               cfg: Dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every draw of the augmentation chain for a batch of ``b`` images
    with box capacity ``n``, on the CPU.  One generator per op slot is
    split from ``generator`` in a fixed order whether or not its op runs,
    so turning one optional op on never changes another op's draws (as
    the JAX stage's per-op keys).  Only the ops ``cfg`` runs are drawn."""
    gens = {name: split_generator(generator) for name in SLOTS}
    d = {'resize': A.draw_resize_crop_pad(
             gens['resize'], b, scale_range=tuple(cfg.get(
                 'scale_range', (0.7, 1.3)))),
         'hflip': A.draw_gate(gens['hflip'], b, cfg.get('hflip_prob', 0.5)),
         'brightness': A.draw_brightness(gens['brightness'], b),
         'contrast': A.draw_contrast(gens['contrast'], b),
         'saturation': A.draw_saturation(gens['saturation'], b),
         'hue': A.draw_hue(gens['hue'], b),
         'grayscale': A.draw_gate(gens['grayscale'], b,
                                  cfg.get('grayscale_prob', 0.1)),
         'rotate90': A.draw_rotate90(gens['rotate90'], b,
                                     cfg.get('rotate_prob', 0.05))}
    if cfg.get('blur_prob', 0.0) > 0:
        d['blur'] = A.draw_gate(gens['blur'], b, cfg['blur_prob'])
    if cfg.get('sharpness_prob', 0.0) > 0:
        d['sharpness'] = A.draw_sharpness(gens['sharpness'], b,
                                          cfg['sharpness_prob'])
    if cfg.get('motion_blur_prob', 0.0) > 0:
        d['motion_blur'] = A.draw_motion_blur(gens['motion_blur'], b,
                                              cfg['motion_blur_prob'])
    if cfg.get('rotate_any_prob', 0.0) > 0:
        d['rotate_any'] = A.draw_rotate_any(
            gens['rotate_any'], b, cfg['rotate_any_prob'],
            cfg.get('rotate_max_deg', 15.0))
    if cfg.get('enhance_type') == 'gridmask':
        d['gridmask'] = A.draw_gridmask(gens['gridmask'], b,
                                        cfg.get('gridmask_prob', 0.1))
    mosaic_prob = cfg.get('mosaic_prob', 0.0)
    mixup_prob = cfg.get('mixup_prob', 0.0)
    if mosaic_prob > 0:
        d['mosaic'] = A.draw_mosaic(gens['mosaic'], b, mosaic_prob)
    if mixup_prob > 0:
        d['mixup'] = A.draw_mixup(gens['mixup'], b, mixup_prob)
    if cfg.get('copypaste_prob', 0.0) > 0:
        cp_max = int(cfg.get('copypaste_max', 4))
        cap = n * calculate_expansion_factor(mosaic_prob, mixup_prob)
        d['copypaste'] = A.draw_copypaste(
            gens['copypaste'], b, cap + cp_max, cfg['copypaste_prob'],
            cp_max)
    return d


def apply_chain(images: torch.Tensor, boxes: torch.Tensor, draws: Dict,
                cfg: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation chain of the JAX stage, in its order and with its
    gating, from ``draws`` (:func:`draw_chain`, on the images' device).
    Mosaic runs whenever ``mosaic_prob > 0``, whatever ``enhance_type``
    says, as in the JAX stage."""
    images, boxes = A.apply_resize_crop_pad(images, boxes, draws['resize'])
    images, boxes = A.apply_hflip(images, boxes, draws['hflip'])
    images, boxes = A.apply_brightness(images, boxes, draws['brightness'])
    images, boxes = A.apply_contrast(images, boxes, draws['contrast'])
    images, boxes = A.apply_saturation(images, boxes, draws['saturation'])
    images, boxes = A.apply_hue(images, boxes, draws['hue'])
    images, boxes = A.apply_grayscale(images, boxes, draws['grayscale'])
    if cfg.get('blur_prob', 0.0) > 0:
        images, boxes = A.apply_blur(images, boxes, draws['blur'])
    if cfg.get('sharpness_prob', 0.0) > 0:
        images, boxes = A.apply_sharpness(images, boxes, draws['sharpness'])
    if cfg.get('motion_blur_prob', 0.0) > 0:
        images, boxes = A.apply_motion_blur(images, boxes,
                                            draws['motion_blur'])
    if cfg.get('rotate_any_prob', 0.0) > 0:
        images, boxes = A.apply_rotate_any(images, boxes,
                                           draws['rotate_any'])
    images, boxes = A.apply_rotate90(images, boxes, draws['rotate90'])
    if cfg.get('enhance_type') == 'gridmask':
        images, boxes = A.apply_gridmask(images, boxes, draws['gridmask'])
    mosaic_prob = cfg.get('mosaic_prob', 0.0)
    mixup_prob = cfg.get('mixup_prob', 0.0)
    boxes = A.expand_box_capacity(
        boxes, calculate_expansion_factor(mosaic_prob, mixup_prob))
    if mosaic_prob > 0:
        images, boxes = A.apply_mosaic(images, boxes, draws['mosaic'])
    if mixup_prob > 0:
        images, boxes = A.apply_mixup(images, boxes, draws['mixup'])
    if cfg.get('copypaste_prob', 0.0) > 0:
        # +copypaste_max slots (additive) hold the pasted boxes
        cp_max = int(cfg.get('copypaste_max', 4))
        boxes = F.pad(boxes, (0, 0, 0, cp_max))
        images, boxes = A.apply_copypaste(images, boxes, draws['copypaste'],
                                          max_paste=cp_max)
    return images, boxes


def _device_stage(parts, boxes, generator, aug_cfg, anchors, num_classes,
                  input_hw, train, multi_anchor_assign=False, draws=None):
    """pixels (see :func:`pixels_to_f32`) + boxes ``[B, N, 5]`` -> (images
    f32 [0, 1], y_true, boxes after augmentation).

    A train stage with augmentation on draws from ``generator`` (or takes
    ``draws`` made by :func:`draw_chain`) and runs :func:`apply_chain` on
    the images' device; the boxes then live there too, and the encoder
    reads their valid count with one host sync."""
    images = pixels_to_f32(parts)
    cfg = dict(aug_cfg or {})
    if augmentation_enabled(cfg, train):
        if draws is None:
            if generator is None:
                raise ValueError('an augmenting stage needs a generator')
            draws = draw_chain(generator, images.shape[0], boxes.shape[1],
                               cfg)
        boxes = to_device(boxes, images.device, torch.float32)
        images, boxes = apply_chain(images, boxes,
                                    A.draws_to(draws, images.device), cfg)
    images = A.normalize_images(images)
    y_true = encode_targets(boxes, anchors, num_classes, input_hw,
                            multi_anchor_assign=multi_anchor_assign,
                            device=images.device)
    return images, y_true, boxes
