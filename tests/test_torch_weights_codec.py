"""The port's flax msgpack codec (``models/weights.py``) against flax.

The port reads and writes the JAX package's weight files without the
``msgpack`` package (the card's host has none).  Both directions are held
to flax exactly: the port reads what ``flax.serialization`` writes and flax
reads what the port writes, with equal arrays (bit for bit) and equal bytes
on both sides; and the port's weight loader runs with ``msgpack`` blocked
from import.
"""

import subprocess
import sys
import textwrap

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest

from multigriddet_tpu_torch.models import (create_model, random_flax_variables,
                                           weights)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        want = np.asarray(want)
        got = np.asarray(got)
        if want.dtype == jnp.bfloat16:          # the port reads bf16 as f32
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want, (got, want)


def _model_tree(arch, bundle):
    model = create_model(arch, num_anchors=(3, 3, 3), num_classes=80)
    params, stats = random_flax_variables(model, seed=3)
    return {'params': params, 'batch_stats': stats} if bundle else params


def _mixed_tree():
    """Every type flax writes into a weights file, and the msgpack header
    sizes around their limits."""
    rng = np.random.RandomState(0)
    return {
        'f32': rng.rand(3, 4).astype(np.float32),
        'f64': rng.rand(5),
        'i8': np.arange(-4, 4, dtype=np.int8),
        'i64': np.array([2 ** 40, -2 ** 40]),
        'u8': np.arange(300, dtype=np.int64).astype(np.uint8),
        'bool': np.array([True, False]),
        'bf16': np.asarray(jnp.asarray(rng.rand(2, 3), jnp.bfloat16)),
        'scalar0d': np.array(1.5, np.float32),
        'empty': np.zeros((0, 3), np.float32),
        'np_scalars': {'f': np.float32(2.5), 'i': np.int32(-7)},
        'ints': {'a': 0, 'b': 127, 'c': 128, 'd': -32, 'e': -33,
                 'f': 2 ** 16, 'g': -2 ** 31, 'h': 2 ** 63 - 1},
        'floats': {'a': 0.1, 'b': -1e300},
        'complex': 1.5 - 2j,
        'strings': {'short': 'x' * 31, 'str8': 'y' * 32, 'str16': 'z' * 300,
                    'utf8': 'café'},
        'bytes': b'\x00\x01' * 200,
        'flags': {'t': True, 'f': False, 'none': None},
        'list': [1, 2.0, 'three'],
        'map16': {f'k{i}': i for i in range(20)},
    }


@pytest.mark.parametrize('tree', ['darknet_bundle', 'darknet_params',
                                  'tiny_bundle', 'mixed'])
def test_codec_matches_flax_both_ways(tree):
    if tree == 'mixed':
        t = _mixed_tree()
    else:
        arch, kind = tree.split('_')
        t = _model_tree(f'multigriddet_{arch}', kind == 'bundle')
    flax_bytes = fser.msgpack_serialize(t)
    _assert_trees_equal(weights.msgpack_restore(flax_bytes), t)
    ours = weights.msgpack_serialize(t)
    assert ours == flax_bytes
    _assert_trees_equal(weights.msgpack_restore(ours), t)
    back = fser.msgpack_restore(ours)
    _assert_trees_equal(
        {k: back[k] for k in t if k != 'bf16'},
        {k: t[k] for k in t if k != 'bf16'})


def test_codec_reads_to_bytes_and_chunked_arrays(monkeypatch):
    """``flax.serialization.to_bytes`` of a params tree, and arrays above
    the chunk size (flax's ``__msgpack_chunked_array__``), both ways."""
    t = _model_tree('multigriddet_tiny', True)
    _assert_trees_equal(weights.msgpack_restore(fser.to_bytes(t)), t)
    monkeypatch.setattr(fser, 'MAX_CHUNK_SIZE', 1000)
    monkeypatch.setattr(weights, 'MAX_CHUNK_SIZE', 1000)
    big = {'w': np.random.RandomState(1).rand(40, 30).astype(np.float32),
           'small': np.arange(5, dtype=np.float32)}
    flax_bytes = fser.msgpack_serialize(big)
    assert b'__msgpack_chunked_array__' in flax_bytes
    assert weights.msgpack_serialize(big) == flax_bytes
    _assert_trees_equal(weights.msgpack_restore(flax_bytes), big)
    _assert_trees_equal(fser.msgpack_restore(weights.msgpack_serialize(big)),
                        big)


def test_codec_rejects_malformed_input():
    with pytest.raises(ValueError, match='truncated'):
        weights.msgpack_restore(fser.msgpack_serialize(
            {'a': np.zeros(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match='trailing'):
        weights.msgpack_restore(fser.msgpack_serialize({'a': 1}) + b'\x00')
    with pytest.raises(TypeError, match='cannot serialize'):
        weights.msgpack_serialize({'a': object()})


@pytest.mark.parametrize('bundle', [True, False])
def test_load_weights_flexible_with_msgpack_blocked(tmp_path, bundle):
    """A file written by the JAX package loads into the port in a fresh
    interpreter where ``import msgpack`` fails, as on the card's host."""
    from multigriddet_tpu.training.checkpoint import save_params
    t = _model_tree('multigriddet_tiny', bundle)
    path = tmp_path / 'w.msgpack'
    save_params(str(path), t)
    want = t['params'] if bundle else t
    np.save(tmp_path / 'kernel.npy',
            want['backbone']['ConvBN_0']['Conv_0']['kernel'])
    code = textwrap.dedent(f'''
        import sys
        sys.modules['msgpack'] = None       # import msgpack -> ImportError
        import numpy as np
        from multigriddet_tpu_torch.models import create_model
        from multigriddet_tpu_torch.training import load_weights_flexible
        m = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=80)
        load_weights_flexible({str(path)!r}, m)
        k = np.load({str(tmp_path / 'kernel.npy')!r})
        got = m.backbone.ConvBN_0.Conv_0.weight.detach().numpy()
        assert (got == k.transpose(3, 2, 0, 1)).all()
        assert 'msgpack' not in [n for n, v in sys.modules.items() if v]
        print('ok')
    ''')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
