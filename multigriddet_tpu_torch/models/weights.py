"""Weight bridge: flax ``{'params', 'batch_stats'}`` trees -> ``state_dict``.

The port's modules carry the flax auto-names (``ConvBN_0``,
``_ResStage_3``, ``_ScaleHead_1``, ``PredictConv_0``/``Conv_0``,
``BatchNorm_0``), so a flax path maps to a ``state_dict`` key by joining
it with dots and renaming the leaf:

=====================  =========================  ===================
flax collection/leaf   ``state_dict`` leaf        layout
=====================  =========================  ===================
params ``kernel``      ``weight``                 HWIO -> OIHW
params ``bias``        ``bias``                   as is
params ``scale``       ``weight`` (BatchNorm)     as is
batch_stats ``mean``   ``running_mean``           as is
batch_stats ``var``    ``running_var``            as is
=====================  =========================  ===================

``load_weights_flexible`` reads the JAX package's msgpack files (the
``{'params', 'batch_stats'}`` bundle or a bare params tree, written by
``flax.serialization.to_bytes``) with the ``msgpack`` package alone.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}

# flax.serialization's msgpack extension codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(params: Mapping[str, Any],
                       batch_stats: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Convert flax trees of arrays into the port's ``state_dict`` entries."""
    out: Dict[str, torch.Tensor] = {}
    trees = [(params, _PARAM_LEAVES)]
    if batch_stats:
        trees.append((batch_stats, _STAT_LEAVES))
    for tree, leaves in trees:
        for path, value in _flatten(tree):
            leaf = path[-1]
            if leaf not in leaves:
                raise KeyError(f'unknown flax leaf {"/".join(path)}')
            arr = np.asarray(value, np.float32)
            if leaf == 'kernel':
                if arr.ndim != 4:
                    raise ValueError(f'{"/".join(path)}: expected an HWIO '
                                     f'conv kernel, got shape {arr.shape}')
                arr = arr.transpose(3, 2, 0, 1)
            key = '.'.join(path[:-1] + (leaves[leaf],))
            out[key] = torch.tensor(arr)
    return out


def load_flax_variables(model: nn.Module, params: Mapping[str, Any],
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> nn.Module:
    """Load flax trees into ``model`` in place.

    Every parameter of the model must be present and nothing may be left
    over; running statistics are required when ``batch_stats`` is given
    and otherwise keep their current values (a bare params file).
    """
    sd = flax_to_state_dict(params, batch_stats)
    own = model.state_dict()
    expected = {k for k in own if not k.endswith('num_batches_tracked')}
    if not batch_stats:
        expected = {k for k in expected
                    if not k.endswith(('running_mean', 'running_var'))}
    missing, extra = sorted(expected - set(sd)), sorted(set(sd) - expected)
    if missing or extra:
        raise KeyError(f'weight bridge mismatch: missing {missing[:8]} '
                       f'({len(missing)}), leftover {extra[:8]} '
                       f'({len(extra)})')
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f'{k}: shape {tuple(v.shape)} does not match '
                             f'the model ({tuple(own[k].shape)})')
    model.load_state_dict(sd, strict=False)
    return model


def random_flax_variables(model: nn.Module, seed: int = 0
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Seeded numpy weights in the flax layout for every entry of ``model``.

    Conv kernels are LeCun-normal (std ``1/sqrt(fan_in)``); BatchNorm
    scale, bias and running statistics are drawn around identity so the
    random network keeps activations finite at full depth.
    """
    rng = np.random.RandomState(seed)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    inverse = {('weight', 4): 'kernel', ('weight', 1): 'scale',
               ('bias', 1): 'bias'}
    for key, t in model.state_dict().items():
        *path, leaf = key.split('.')
        shape = tuple(t.shape)
        if leaf == 'num_batches_tracked':
            continue
        if leaf in ('running_mean', 'running_var'):
            tree, name = stats, leaf[len('running_'):]
            if name == 'mean':
                value = rng.normal(0.0, 0.1, shape)
            else:
                value = rng.uniform(0.5, 1.5, shape)
        else:
            tree, name = params, inverse[(leaf, len(shape))]
            if name == 'kernel':
                o, i, kh, kw = shape
                value = rng.normal(0.0, 1.0 / np.sqrt(i * kh * kw),
                                   (kh, kw, i, o))
            elif name == 'scale':
                value = rng.uniform(0.8, 1.2, shape)
            else:
                value = rng.normal(0.0, 0.1, shape)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = value.astype(np.float32)
    return params, stats


# ---------------------------------------------------------------------------
# flax msgpack files, read without flax
# ---------------------------------------------------------------------------

def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b'bfloat16':
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name.decode())).reshape(
        shape, order='C')


def _ext_hook(code: int, data: bytes):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    """Reassemble arrays that flax split into ``__msgpack_chunked_array__``
    dicts (arrays above 1 GiB)."""
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        chunks = tree['chunks']
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        shape = tree['shape']
        return flat.reshape(tuple(shape[str(i)] for i in range(len(shape))))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """``flax.serialization.msgpack_restore`` without flax."""
    import msgpack
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def load_weights_flexible(path: str, model: nn.Module) -> nn.Module:
    """Load a flax weights file into ``model`` in place.

    Accepts the ``{'params', 'batch_stats'}`` bundle (the trainer's
    ``final_model.msgpack``) or a bare params tree, as
    ``multigriddet_tpu/training/checkpoint.py:116-140`` does.
    """
    with open(path, 'rb') as f:
        raw = msgpack_restore(f.read())
    if isinstance(raw, dict) and 'params' in raw:
        return load_flax_variables(model, raw['params'],
                                   raw.get('batch_stats') or None)
    return load_flax_variables(model, raw)
