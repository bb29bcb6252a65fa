"""Config -> model / loss / optimizer factories.

Counterpart of ``multigriddet_tpu/config/builder.py``.  The model holds
float32 parameters and computes in ``resolve_compute_dtype``'s dtype:
bfloat16 by default for serving (``environment.mixed_precision``), with
float32 predict-conv outputs, decode and NMS.

The training half keeps the JAX package's contract and its traps: Adam's
default epsilon is 1e-7 (torch's is 1e-8); AdamW's decoupled weight decay
defaults to ``decay`` or 5e-4; SGD defaults to momentum 0.937 without
Nesterov; ``decay`` on adam/sgd warns and is ignored.  Learning-rate
schedules are plain functions of the optimizer-update count.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..losses import LossConfig
from ..models import (build_custom, create_model, load_flax_variables,
                      load_weights_flexible, random_flax_variables)
from ..utils.anchors import (class_counts_from_annotations,
                             compute_class_weights, load_anchors,
                             load_classes)


def model_spec_from_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve the ``model.preset`` block into constructor arguments."""
    model_cfg = config.get('model', {}) or {}
    preset = model_cfg.get('preset', {}) or {}
    if model_cfg and not preset and model_cfg.get('type', 'preset') == 'preset':
        print("WARNING: config has a 'model' block but no 'model.preset' "
              "section — falling back to defaults (multigriddet_darknet, "
              "COCO anchors).")
    input_shape = tuple(preset.get('input_shape', (608, 608, 3)))
    num_classes = preset.get('num_classes')
    classes_path = preset.get('classes_path') or (
        config.get('data', {}) or {}).get('classes_path')
    class_names: Optional[List[str]] = None
    if classes_path:
        try:
            class_names = load_classes(classes_path)
        except OSError:
            class_names = None
    if num_classes is None:
        num_classes = len(class_names) if class_names else 80
    return {
        'architecture': preset.get('architecture', 'multigriddet_darknet'),
        'input_shape': input_shape,
        'num_classes': int(num_classes),
        'class_names': class_names,
        'anchors': load_anchors(preset.get('anchors_path')),
        'custom': model_cfg.get('custom'),
        'mode': model_cfg.get('type', 'preset'),
    }


def resolve_compute_dtype(config: Dict[str, Any],
                          default_mixed: bool = False) -> torch.dtype:
    """Compute dtype from ``environment.mixed_precision``."""
    mixed = (config.get('environment', {}) or {}).get('mixed_precision')
    if mixed is None:
        mixed = default_mixed
    return torch.bfloat16 if mixed else torch.float32


def bn_momentum_from_config(config: Dict[str, Any]) -> float:
    """``model.preset.bn_momentum``, else ``training.bn_momentum``, else
    0.99 (flax convention: the weight of the old running value)."""
    return float(
        (config.get('model', {}) or {}).get('preset', {}).get(
            'bn_momentum',
            (config.get('training', {}) or {}).get('bn_momentum', 0.99)))


def build_model_from_config(config: Dict[str, Any],
                            dtype: torch.dtype = torch.float32):
    """Instantiate the detector (eval mode, on the CPU) and its spec.

    ``model.type: custom`` composes ``model.custom.{backbone,neck,head}``
    by their ``type`` (the neck's other keys are its keyword arguments,
    ``channels`` as a tuple), as the JAX builder does; it reads neither
    ``bn_momentum`` nor ``environment.remat``.  A preset reads both
    (``remat``: false, true / ``'conv'`` or ``'full'``).
    ``model.s2d_stem`` is not read: it selects a TPU execution rewrite of
    the same function and parameters in the JAX package, with no gain on
    a GPU (ROADMAP item 19).
    """
    spec = model_spec_from_config(config)
    num_anchors = tuple(len(a) for a in spec['anchors'])
    if spec['mode'] == 'custom' and spec['custom']:
        custom = spec['custom']
        neck_cfg = dict(custom.get('neck', {}) or {})
        neck_type = neck_cfg.pop('type', None)
        if 'channels' in neck_cfg:
            neck_cfg['channels'] = tuple(neck_cfg['channels'])
        model = build_custom(
            (custom.get('backbone', {}) or {}).get('type', 'darknet53'),
            (custom.get('head', {}) or {}).get('type', 'multigrid'),
            neck_name=neck_type, neck_kwargs=neck_cfg,
            num_anchors=num_anchors, num_classes=spec['num_classes'],
            dtype=dtype)
    else:
        model = create_model(
            spec['architecture'], num_anchors=num_anchors,
            num_classes=spec['num_classes'], dtype=dtype,
            bn_momentum=bn_momentum_from_config(config),
            remat=(config.get('environment', {}) or {}).get('remat', False))
    return model, spec


def build_model_for_inference(config: Dict[str, Any],
                              weights_path: Optional[str] = None,
                              device=None):
    """Build the detector with inference weights on ``device``.

    ``weights_path`` falls back to the config's ``weights_path``; with no
    file, the weights are seeded random (``random_flax_variables``, seed
    0) and a warning says so.  Returns ``(model, spec)``.
    """
    dev = resolve_device(device)
    model, spec = build_model_from_config(
        config, dtype=resolve_compute_dtype(config, default_mixed=True))
    if weights_path is None:
        weights_path = config.get('weights_path')
    if weights_path and os.path.exists(weights_path):
        load_weights_flexible(weights_path, model)
        print(f'Loaded weights from {weights_path}')
    else:
        print(f'WARNING: no weights loaded ({weights_path or "no path"}); '
              'seeded random init')
        load_flax_variables(model, *random_flax_variables(model, seed=0))
    return model.to(dev), spec


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def init_flax_like(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Seeded initialization with flax's initializers, in place: conv
    kernels LeCun-normal (a normal of std ``sqrt(1 / fan_in) / .8796``
    truncated at two stds), biases 0, BatchNorm scale 1, bias 0, running
    mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, t in model.state_dict(keep_vars=True).items():
            leaf = name.rsplit('.', 1)[-1]
            if leaf == 'weight' and t.dim() == 4:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                w = torch.empty(t.shape)
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
                t.copy_(w)
            elif leaf in ('weight', 'running_var'):
                t.fill_(1.0)
            elif leaf in ('bias', 'running_mean'):
                t.zero_()
    return model


def build_model_for_training(config: Dict[str, Any],
                             weights_path: Optional[str] = None,
                             backbone_weights_path: Optional[str] = None,
                             device=None, seed: int = 0):
    """Build the detector for training on ``device`` (train mode, compute
    dtype from ``environment.mixed_precision``, float32 by default),
    seeded flax-like init, then the weights of ``resume.weights_path`` or
    only the backbone of ``resume.backbone_weights_path``.

    Returns ``(model, spec, loss_cfg)``.
    """
    from ..training.checkpoint import load_backbone_flexible
    dev = resolve_device(device)
    model, spec = build_model_from_config(config,
                                          dtype=resolve_compute_dtype(config))
    init_flax_like(model, seed)
    resume = config.get('resume', {}) or {}
    weights_path = weights_path or resume.get('weights_path')
    backbone_weights_path = (backbone_weights_path
                             or resume.get('backbone_weights_path'))
    if weights_path and os.path.exists(weights_path):
        load_weights_flexible(weights_path, model)
        print(f'Loaded full weights from: {weights_path}')
    elif backbone_weights_path and os.path.exists(backbone_weights_path):
        load_backbone_flexible(backbone_weights_path, model)
        print(f'Loaded backbone weights from: {backbone_weights_path}')
    elif weights_path or backbone_weights_path:
        print(f'WARNING: weights file not found: '
              f'{weights_path or backbone_weights_path}')
    return model.to(dev).train(), spec, loss_config_from_config(config)


def loss_config_from_config(config: Dict[str, Any]) -> LossConfig:
    """``LossConfig`` from the ``training`` block.  The ignore-mask GT
    capacity defaults to the pipeline's box capacity after expansion
    (``max_boxes_per_image`` x the mosaic/mixup factor, + the copy-paste
    slots), read from the augmentation block as the JAX package reads it."""
    from ..data.pipeline import calculate_expansion_factor
    training = config.get('training', {}) or {}
    loss = training.get('loss', {}) or {}
    aug = training.get('augmentation', {}) or {}
    max_gt = loss.get('max_gt_boxes')
    if max_gt is None:
        factor = calculate_expansion_factor(
            float(aug.get('mosaic_prob', 0.0) or 0.0),
            float(aug.get('mixup_prob', 0.0) or 0.0))
        max_gt = int(aug.get('max_boxes_per_image', 100)) * factor
        if float(aug.get('copypaste_prob', 0.0) or 0.0) > 0:
            max_gt += int(aug.get('copypaste_max', 4))
    norm = training.get('loss_normalization', ['batch'])
    if isinstance(norm, str):
        norm = [norm]
    iou_type = 'giou'
    for key, kind in (('use_giou_loss', 'giou'), ('use_diou_loss', 'diou'),
                      ('use_ciou_loss', 'ciou')):
        if loss.get(key):
            iou_type = kind
    return LossConfig(
        loss_option=int(training.get('loss_option', 2)),
        ignore_thresh=float(loss.get('ignore_thresh', 0.5)),
        coord_scale=float(loss.get('coord_scale', 1.0)),
        object_scale=float(loss.get('object_scale', 1.0)),
        no_object_scale=float(loss.get('no_object_scale', 1.0)),
        class_scale=float(loss.get('class_scale', 1.0)),
        anchor_scale=float(loss.get('anchor_scale', 1.0)),
        label_smoothing=float(training.get('label_smoothing', 0.0)),
        use_focal_loss=bool(loss.get('use_focal_loss', False)),
        use_softmax_loss=bool(loss.get('use_softmax_loss', False)),
        iou_loss_type=iou_type,
        use_iou_aware_objectness=bool(
            loss.get('use_iou_aware_objectness', False)),
        iou_objectness_power=float(loss.get('iou_objectness_power', 1.5)),
        iou_objectness_ratio=float(loss.get('iou_objectness_ratio', 1.0)),
        trainable_nms_weight=float(loss.get('trainable_nms_weight', 0.0)),
        trainable_nms_power=float(loss.get('trainable_nms_power', 2.0)),
        use_consensus_loss=bool(loss.get('use_consensus_loss', False)),
        consensus_kernel_size=int(loss.get('consensus_kernel_size', 3)),
        consensus_iou_power=float(loss.get('consensus_iou_power', 1.5)),
        consensus_min_iou=float(loss.get('consensus_min_iou', 1e-3)),
        consensus_coord_scale=float(loss.get('consensus_coord_scale', 0.5)),
        consensus_obj_scale=float(loss.get('consensus_obj_scale', 0.5)),
        consensus_class_scale=float(loss.get('consensus_class_scale', 0.3)),
        consensus_stop_gradient=bool(
            loss.get('consensus_stop_gradient', True)),
        consensus_center_tolerance=float(
            loss.get('consensus_center_tolerance', 1e-4)),
        loss_normalization=tuple(norm),
        max_gt_boxes=int(max_gt),
    )


def class_weights_from_config(config: Dict[str, Any], num_classes: int,
                              annotation_lines=None) -> Optional[np.ndarray]:
    """``training.class_weights``: null, 'auto' (from the annotation
    counts) or an explicit list."""
    training = config.get('training', {}) or {}
    cw = training.get('class_weights')
    if cw is None:
        return None
    if cw == 'auto':
        if not annotation_lines:
            return None
        counts = class_counts_from_annotations(annotation_lines, num_classes)
        return compute_class_weights(
            counts, training.get('class_weights_method', 'balanced'))
    arr = np.asarray(cw, np.float32)
    if arr.shape != (num_classes,):
        raise ValueError(
            f'class_weights length {arr.shape} != num_classes {num_classes}')
    return arr


def resolve_learning_rate(config: Dict[str, Any]) -> float:
    """``training.learning_rate`` > ``optimizer.learning_rate`` > 1e-3."""
    training = config.get('training', {}) or {}
    optimizer = config.get('optimizer', {}) or {}
    if training.get('learning_rate') is not None:
        return float(training['learning_rate'])
    if optimizer.get('learning_rate') is not None:
        return float(optimizer['learning_rate'])
    return 1e-3


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value``
    at ``decay_steps`` (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError('the cosine decay needs decay_steps > warmup_steps')

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = min(max(count, 0), warmup_steps)
            frac = 1 - c / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)
    return schedule


def make_lr_schedule(config: Dict[str, Any], steps_per_epoch: int,
                     total_epochs: int) -> Callable[[int], float]:
    """Cosine annealing with warmup, or constant: the learning rate as a
    function of the optimizer-update count (reduce_on_plateau is the
    trainer's, on the validation signal)."""
    base_lr = resolve_learning_rate(config)
    sched_cfg = config.get('lr_schedule', {}) or {}
    if sched_cfg.get('type', 'constant') == 'cosine_annealing':
        warmup_epochs = int(sched_cfg.get('warmup_epochs', 0))
        warmup_factor = float(sched_cfg.get('warmup_lr_factor', 0.01))
        min_lr = float(sched_cfg.get('min_lr', 1e-7))
        warmup_steps = max(warmup_epochs * steps_per_epoch, 0)
        decay_steps = max(total_epochs * steps_per_epoch - warmup_steps, 1)
        return warmup_cosine_decay_schedule(
            init_value=base_lr * warmup_factor, peak_value=base_lr,
            warmup_steps=max(warmup_steps, 1),
            decay_steps=decay_steps + max(warmup_steps, 1), end_value=min_lr)
    return lambda count: base_lr


def _make_optimizer(kind: str, lr: float, opt_cfg: Dict[str, Any],
                    params) -> torch.optim.Optimizer:
    if kind in ('adam', 'sgd') and opt_cfg.get('decay'):
        warnings.warn(f'optimizer.decay is ignored for {kind} (the '
                      "reference's Keras 3 runtime ignores it too); use "
                      'adamw with weight_decay for decoupled decay')
    betas = (float(opt_cfg.get('beta_1', 0.9)),
             float(opt_cfg.get('beta_2', 0.999)))
    eps = float(opt_cfg.get('epsilon', 1e-7))
    if kind == 'adam':
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if kind == 'adamw':
        return torch.optim.AdamW(
            params, lr=lr, betas=betas, eps=eps,
            weight_decay=float(opt_cfg.get('weight_decay',
                                           opt_cfg.get('decay', 5e-4))))
    if kind == 'sgd':
        return torch.optim.SGD(
            params, lr=lr, momentum=float(opt_cfg.get('momentum', 0.937)),
            nesterov=bool(opt_cfg.get('nesterov', False)))
    raise ValueError(f'unknown optimizer type {kind!r}')


def create_optimizer_from_config(
        config: Dict[str, Any], params,
        learning_rate: Union[None, float, Callable[[int], float]] = None,
        accumulation: int = 1):
    """Adam / AdamW / SGD over ``params`` as a
    :class:`~multigriddet_tpu_torch.training.state.TrainOptimizer`.

    ``learning_rate`` is a schedule of the update count, or a float (fixed,
    and changeable in place with ``set_lr``, which keeps the moments:
    reduce-on-plateau); default :func:`resolve_learning_rate`.
    ``accumulation`` averages that many micro-batches' gradients into one
    update (``training.gradient_accumulation``).
    """
    from ..training.state import TrainOptimizer
    opt_cfg = config.get('optimizer', {}) or {}
    kind = (opt_cfg.get('type') or 'adam').lower()
    lr = learning_rate if learning_rate is not None else \
        resolve_learning_rate(config)
    schedule = lr if callable(lr) else None
    inner = _make_optimizer(kind, float(lr(0)) if schedule else float(lr),
                            opt_cfg, list(params))
    return TrainOptimizer(inner, schedule, accumulation)


def get_model_info(config: Dict[str, Any]) -> Dict[str, Any]:
    """Config-level model introspection, the JAX package's
    ``get_model_info`` (reference ``model_builder.py:302-330``).

    The same schema: name, type, architecture, num_classes, input_shape and
    num_anchors_per_head, read from the ``model.preset`` or
    ``model.custom`` block without building anything.
    """
    model_cfg = config.get('model', {}) or {}
    info = {
        'name': model_cfg.get('name', 'unknown'),
        'type': model_cfg.get('type', 'preset'),
        'architecture': None,
        'num_classes': None,
        'input_shape': None,
        'num_anchors_per_head': [3, 3, 3],
    }
    if info['type'] == 'preset':
        preset = model_cfg.get('preset', {}) or {}
        info.update(
            architecture=preset.get('architecture'),
            num_classes=preset.get('num_classes'),
            input_shape=tuple(preset['input_shape'])
            if preset.get('input_shape') else None)
    elif info['type'] == 'custom':
        custom = model_cfg.get('custom', {}) or {}
        head = custom.get('head', {}) or {}
        info.update(
            architecture='custom_{}_{}_{}'.format(
                (custom.get('backbone', {}) or {}).get('type'),
                (custom.get('neck', {}) or {}).get('type'),
                head.get('type')),
            num_classes=head.get('num_classes', 80),
            input_shape=tuple(custom.get('input_shape', (608, 608, 3))))
    return info
