"""Keras-HDF5 weights -> the port's models (layer-order based).

Counterpart of ``multigriddet_tpu/models/porting.py``: the pretrained
Keras weights of the original MultiGridDet, BatchNorm moving statistics
included, load into a port model in place, with an audit of the units
loaded and of those missing or of another shape.  It is an offline step
on a host with ``h5py`` (imported here only when a file is read).

Matching is the JAX function's, unit for unit:

* both files are read: the legacy Keras-2 layout (``layer_names`` /
  ``weight_names`` attributes, creation order) and the Keras-3
  ``layers/<name>/vars/{0..n}`` group (creation order rebuilt from each
  name's numeric suffix);
* the model's convs and BatchNorms come in execution order, which forward
  pre-hooks record on one dry forward (the counterpart of
  ``module_call_order``: registration order is not execution order, e.g.
  ResNet's shortcut is registered first).  Each block's own convs and
  BatchNorms run in the order they are registered in it;
* convs are matched per shape class (the k-th h5 kernel of a shape to the
  k-th model kernel of that shape), biased (predict) and bias-free convs
  separately; a Keras depthwise kernel ``(k, k, C, 1)`` fills a
  ``groups=C`` conv; the bias-free permutation carries over to the
  BatchNorms, since every bias-free conv owns one BatchNorm in both.

Keras kernels are HWIO; the port's are OIHW.  Shapes are compared in the
HWIO view of the port's kernels (a depthwise ``(C, 1, k, k)`` is ``(k,
k, 1, C)``, as in flax).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


def module_call_order(model: nn.Module, input_hw=(64, 64)
                      ) -> List[Tuple[str, nn.Module]]:
    """The model's ``Conv2d`` and ``BatchNorm2d`` modules, by name, in
    the order one dry forward of a ``[1, H, W, 3]`` zero image runs
    them."""
    names = {m: n for n, m in model.named_modules()}
    order, seen = [], set()

    def record(mod, _inputs):
        for child in mod.children():
            if (isinstance(child, (nn.Conv2d, nn.BatchNorm2d))
                    and child not in seen):
                seen.add(child)
                order.append((names[child], child))

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()]
    was_training = model.training
    try:
        p = next(model.parameters())
        with torch.no_grad():
            model.eval()(torch.zeros((1, *input_hw, 3), dtype=p.dtype,
                                     device=p.device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    # modules that never ran keep their registration order, at the end
    order += [(n, m) for n, m in model.named_modules()
              if isinstance(m, (nn.Conv2d, nn.BatchNorm2d))
              and m not in seen]
    return order


def _hwio_shape(conv: nn.Conv2d) -> Tuple[int, ...]:
    o, i, kh, kw = conv.weight.shape
    return (kh, kw, i, o)


def _name_key(name: str):
    """('conv2d', 5) from 'conv2d_5'; index 0 when there is no suffix."""
    parts = name.rsplit('_', 1)
    if len(parts) == 2 and parts[1].isdigit():
        return parts[0], int(parts[1])
    return name, 0


def _collect_h5_units(h5file):
    """Ordered ``('conv' | 'bn', arrays, layer name)`` units of a Keras
    weights file, in either layout."""
    units = []
    if 'layers' in h5file:  # Keras 3 .weights.h5
        layers_grp = h5file['layers']
        for lname in sorted(layers_grp.keys(), key=_name_key):
            grp = layers_grp[lname]
            if 'vars' not in grp:
                continue
            var_keys = sorted(grp['vars'].keys(), key=lambda k: int(k))
            arrays = [np.asarray(grp['vars'][k]) for k in var_keys]
            if not arrays:
                continue
            if arrays[0].ndim == 4:
                unit = {'kernel': arrays[0]}
                if len(arrays) > 1 and arrays[1].ndim == 1:
                    unit['bias'] = arrays[1]
                units.append(('conv', unit, lname))
            elif len(arrays) == 4 and all(a.ndim == 1 for a in arrays):
                units.append(('bn', {
                    'scale': arrays[0], 'bias': arrays[1],
                    'mean': arrays[2], 'var': arrays[3]}, lname))
        return units

    root = h5file['model_weights'] if 'model_weights' in h5file else h5file
    layer_names = [n.decode() if isinstance(n, bytes) else n
                   for n in root.attrs.get('layer_names', list(root.keys()))]
    for lname in layer_names:
        grp = root[lname]
        weight_names = [n.decode() if isinstance(n, bytes) else n
                        for n in grp.attrs.get('weight_names', [])]
        arrays = {wn.split('/')[-1].split(':')[0]: np.asarray(grp[wn])
                  for wn in weight_names}
        if not arrays:
            continue
        if 'kernel' in arrays or any(a.ndim == 4 for a in arrays.values()):
            kernel = arrays.get('kernel')
            if kernel is None:
                kernel = next(a for a in arrays.values() if a.ndim == 4)
            unit = {'kernel': kernel}
            if 'bias' in arrays:
                unit['bias'] = arrays['bias']
            units.append(('conv', unit, lname))
        elif 'gamma' in arrays or 'moving_mean' in arrays:
            units.append(('bn', {
                'scale': arrays.get('gamma'),
                'bias': arrays.get('beta'),
                'mean': arrays.get('moving_mean'),
                'var': arrays.get('moving_variance')}, lname))
    return units


def _is_dw_model(conv: nn.Conv2d) -> bool:
    s = _hwio_shape(conv)
    return s[2] == 1 and s[3] > 1


def _is_dw_h5(unit) -> bool:
    s = unit['kernel'].shape
    return len(s) == 4 and s[3] == 1 and s[2] > 1


def _match_stream(model_convs, h5_convs):
    """Per-shape-class matching: ``(model index, h5 index, transpose)``
    triples.  A depthwise model kernel with no same-shape pool takes the
    Keras depthwise shape ``(k, k, C, 1)``, transposed on assignment."""
    by_shape_h5 = defaultdict(list)
    for hi, (_, hu, _) in enumerate(h5_convs):
        by_shape_h5[tuple(hu['kernel'].shape)].append(hi)
    pairs = []
    taken = defaultdict(int)
    for fi, (_, conv) in enumerate(model_convs):
        shape = _hwio_shape(conv)
        candidates = [(shape, False)]
        if shape[2] == 1 and shape[3] > 1:
            candidates.append(((shape[0], shape[1], shape[3], 1), True))
        for cand, transpose in candidates:
            pool = by_shape_h5.get(cand, [])
            k = taken[cand]
            if k < len(pool):
                pairs.append((fi, pool[k], transpose))
                taken[cand] += 1
                break
    return pairs


def _reorder_h5_by_class(h_stream, m_stream):
    """The h5 bias-free conv stream in creation order across layer
    classes: Keras-3 counters are per class (``conv2d_*``,
    ``depthwise_conv2d_*``), so the sorted names put every plain conv
    before every depthwise one; interleaving the two queues to the
    model's pattern restores "the k-th BatchNorm belongs to the k-th
    bias-free conv"."""
    dw = [u for u in h_stream if _is_dw_h5(u[1])]
    if not dw:
        return h_stream
    queues = {True: iter(dw),
              False: iter([u for u in h_stream if not _is_dw_h5(u[1])])}
    out = []
    for _, conv in m_stream:
        nxt = next(queues[_is_dw_model(conv)], None)
        if nxt is not None:
            out.append(nxt)
    used = {id(u) for u in out}
    out.extend(u for u in h_stream if id(u) not in used)
    return out


@torch.no_grad()
def port_keras_weights(h5_path: str, model: nn.Module, input_hw=(64, 64),
                       verbose: bool = True) -> Dict[str, int]:
    """Load Keras h5 weights into ``model`` in place.

    Units of another shape, and units on one side only, are counted and
    skipped.  Returns the audit: ``loaded`` and ``mismatched`` units (as
    the JAX function prints them), and the model's and the file's conv and
    BatchNorm counts."""
    import h5py

    units = module_call_order(model, input_hw)
    convs = [(n, m) for n, m in units if isinstance(m, nn.Conv2d)]
    bns = [(n, m) for n, m in units if isinstance(m, nn.BatchNorm2d)]
    with h5py.File(h5_path, 'r') as f:
        h5_units = _collect_h5_units(f)
    h5_bns = [u for u in h5_units if u[0] == 'bn']

    def assign(t: torch.Tensor, value):
        t.copy_(torch.as_tensor(np.asarray(value, np.float32)))

    loaded = mismatched = 0
    for biased in (False, True):
        m_stream = [(n, c) for n, c in convs
                    if (c.bias is not None) == biased]
        h_stream = [u for u in h5_units
                    if u[0] == 'conv' and ('bias' in u[1]) == biased]
        if not biased:
            h_stream = _reorder_h5_by_class(h_stream, m_stream)
        pairs = _match_stream(m_stream, h_stream)
        mismatched += max(len(m_stream), len(h_stream)) - len(pairs)
        for fi, hi, transpose in pairs:
            conv = m_stream[fi][1]
            hu = h_stream[hi][1]
            kernel = hu['kernel']
            if transpose:   # Keras depthwise (k, k, C, 1) -> (k, k, 1, C)
                kernel = np.transpose(kernel, (0, 1, 3, 2))
            assign(conv.weight, np.transpose(kernel, (3, 2, 0, 1)))
            if conv.bias is not None and 'bias' in hu:
                assign(conv.bias, hu['bias'])
            loaded += 1
        if (not biased and len(m_stream) == len(bns)
                and len(h_stream) == len(h5_bns)):
            # the k-th BatchNorm belongs to the k-th bias-free conv
            for fi, hi, _ in pairs:
                bn = bns[fi][1]
                hu = h5_bns[hi][1]
                if (hu['scale'] is None
                        or tuple(hu['scale'].shape) != tuple(bn.weight.shape)):
                    mismatched += 1
                    continue
                assign(bn.weight, hu['scale'])
                assign(bn.bias, hu['bias'])
                if hu['mean'] is not None:
                    assign(bn.running_mean, hu['mean'])
                    assign(bn.running_var, hu['var'])
                loaded += 1

    audit = {'loaded': loaded, 'mismatched': mismatched,
             'model_convs': len(convs), 'model_bns': len(bns),
             'h5_convs': sum(u[0] == 'conv' for u in h5_units),
             'h5_bns': len(h5_bns)}
    if verbose:
        print(f'Ported {loaded} units from {h5_path} '
              f'({mismatched} shape mismatches; '
              f'model: {audit["model_convs"]} convs / {len(bns)} bns, '
              f'h5: {audit["h5_convs"]} convs / {len(h5_bns)} bns)')
    return audit
