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

The rule covers every module of the zoo without a case of its own:
a depthwise kernel, HWIO ``(k, k, 1, C)``, becomes OIHW ``(C, 1, k, k)``,
the layout of a ``groups=C`` conv; ``SeparableConvBN``'s ``Conv_1`` and
``BatchNorm_1``, ResNet's ``_RNConvBN_*`` and ``_Bottleneck_*``, the
neck's and PANet's modules are paths like any other, since each module
carries its flax auto-name.

``state_dict_to_flax`` is the inverse (OIHW -> HWIO, ``running_*`` ->
``mean``/``var``), for the trainer's exports.

``load_weights_flexible`` reads the JAX package's msgpack files (the
``{'params', 'batch_stats'}`` bundle or a bare params tree, written by
``flax.serialization.to_bytes``) and ``msgpack_serialize`` writes them,
through a codec of the msgpack subset flax uses written here in numpy
alone: the card's host has no ``msgpack`` package.
"""

from __future__ import annotations

import struct
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


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's ``state_dict`` as flax ``(params, batch_stats)`` trees of
    float32 numpy arrays: the inverse of :func:`flax_to_state_dict`."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *path, leaf = key.split('.')
        if leaf == 'num_batches_tracked':
            continue
        arr = t.detach().to('cpu', torch.float32).numpy()
        if leaf in ('running_mean', 'running_var'):
            tree, name = stats, leaf[len('running_'):]
        elif leaf == 'weight' and arr.ndim == 4:
            tree, name = params, 'kernel'
            arr = arr.transpose(2, 3, 1, 0)
        elif leaf == 'weight' and arr.ndim == 1:
            tree, name = params, 'scale'
        elif leaf == 'bias':
            tree, name = params, 'bias'
        else:
            raise KeyError(f'no flax leaf for state_dict entry {key}')
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return params, stats


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
# flax msgpack files, read and written without flax or msgpack
# ---------------------------------------------------------------------------

MAX_CHUNK_SIZE = 2 ** 30    # flax splits arrays above 1 GiB into chunks


class _Reader:
    """A msgpack decoder of the formats flax writes (and the rest of the
    spec's fixed formats, for files written by other packers)."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError('truncated msgpack data')
        self.pos += n
        return bytes(out)

    def _uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), 'big')

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self._map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return self._array(c & 0x0f)
        if 0xa0 <= c <= 0xbf:
            return self.take(c & 0x1f).decode('utf-8')
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):
            return self.take(self._uint(1 << (c - 0xc4)))
        if c in (0xc7, 0xc8, 0xc9):
            n = self._uint(1 << (c - 0xc7))
            return self._ext(n)
        if c == 0xca:
            return struct.unpack('>f', self.take(4))[0]
        if c == 0xcb:
            return struct.unpack('>d', self.take(8))[0]
        if 0xcc <= c <= 0xcf:
            return self._uint(1 << (c - 0xcc))
        if 0xd0 <= c <= 0xd3:
            return int.from_bytes(self.take(1 << (c - 0xd0)), 'big',
                                  signed=True)
        if 0xd4 <= c <= 0xd8:
            return self._ext(1 << (c - 0xd4))
        if 0xd9 <= c <= 0xdb:
            return self.take(self._uint(1 << (c - 0xd9))).decode('utf-8')
        if c in (0xdc, 0xdd):
            return self._array(self._uint(2 if c == 0xdc else 4))
        if c in (0xde, 0xdf):
            return self._map(self._uint(2 if c == 0xde else 4))
        raise ValueError(f'unsupported msgpack byte 0x{c:02x}')

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _array(self, n: int):
        return [self.value() for _ in range(n)]

    def _ext(self, n: int):
        code = int.from_bytes(self.take(1), 'big', signed=True)
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        if code == _EXT_COMPLEX:
            re, im = _Reader(data).value()
            return complex(re, im)
        raise ValueError(f'unknown msgpack extension type {code}')


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data).value()
    if dtype_name == 'bfloat16':
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name)).reshape(
        shape, order='C')


def _header(out: bytearray, n: int, fix: int, fix_max: int,
            wide: Tuple[int, ...]):
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit (or 16/32-bit) forms ``wide`` that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    sizes = (1, 2, 4)[-len(wide):]
    for code, size in zip(wide, sizes):
        if n < 1 << (8 * size):
            out.append(code)
            out += n.to_bytes(size, 'big')
            return
    raise ValueError(f'msgpack length {n} too large')


def _pack_int(out: bytearray, n: int):
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xff)
    elif n >= 0:
        for code, size in ((0xcc, 1), (0xcd, 2), (0xce, 4), (0xcf, 8)):
            if n < 1 << (8 * size):
                out.append(code)
                out += n.to_bytes(size, 'big')
                return
        raise OverflowError(n)
    else:
        for code, size in ((0xd0, 1), (0xd1, 2), (0xd2, 4), (0xd3, 8)):
            if n >= -(1 << (8 * size - 1)):
                out.append(code)
                out += n.to_bytes(size, 'big', signed=True)
                return
        raise OverflowError(n)


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out += code.to_bytes(1, 'big', signed=True)
    out += data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes('C')])
    return bytes(out)


def _pack(out: bytearray, obj):
    """msgpack-python's encoding (``use_bin_type``), with flax's
    extension types for numpy arrays, numpy scalars and complex."""
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack('>d', obj)
    elif isinstance(obj, complex):
        inner = bytearray()
        _pack(inner, [obj.real, obj.imag])
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        _header(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xc4, 0xc5, 0xc6))
        out += obj
    elif isinstance(obj, Mapping):
        _header(out, len(obj), 0x80, 16, (0xde, 0xdf))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (0xdc, 0xdd))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f'cannot serialize {type(obj).__name__}')


def _chunk(tree):
    """The tree as flax writes it: each dict's keys sorted (flax's tree
    map sorts them), and array leaves above ``MAX_CHUNK_SIZE`` bytes split
    into ``__msgpack_chunked_array__`` dicts (kept in flax's own order)."""
    if isinstance(tree, Mapping):
        return {k: _chunk(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {'__msgpack_chunked_array__': True,
                'shape': {str(i): s for i, s in enumerate(tree.shape)},
                'chunks': {str(i): c for i, c in enumerate(chunks)}}
    return tree


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
    """``flax.serialization.msgpack_restore`` without flax or msgpack."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError('trailing bytes after the msgpack value')
    return _unchunk(tree)


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a tree of
    dicts with numpy leaves (keys sorted, as flax's tree map leaves them),
    without flax or msgpack."""
    out = bytearray()
    _pack(out, _chunk(tree))
    return bytes(out)


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
