"""Config -> model factories (the inference half).

Counterpart of ``multigriddet_tpu/config/builder.py:26-162``.  The model
holds float32 parameters and computes in ``resolve_compute_dtype``'s
dtype: bfloat16 by default for serving (``environment.mixed_precision``),
with float32 predict-conv outputs, decode and NMS.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models import (create_model, load_flax_variables,
                      load_weights_flexible, random_flax_variables)
from ..utils.anchors import load_anchors, load_classes


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


def build_model_from_config(config: Dict[str, Any],
                            dtype: torch.dtype = torch.float32):
    """Instantiate the detector (eval mode, on the CPU) and its spec.

    ``model.s2d_stem`` needs nothing here: it selects a TPU execution
    rewrite of the same function and parameters in the JAX package.
    """
    spec = model_spec_from_config(config)
    if spec['mode'] == 'custom' and spec['custom']:
        raise NotImplementedError(
            'custom registry composition is not ported yet (ROADMAP '
            'Queue 1 item 12)')
    model = create_model(spec['architecture'],
                         num_anchors=tuple(len(a) for a in spec['anchors']),
                         num_classes=spec['num_classes'], dtype=dtype)
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
