"""Keras-h5 weight porting of the port against the JAX package's.

Small ``.h5`` files are written with h5py from seeded numpy arrays, in
both layouts the porters read (the legacy Keras-2 ``layer_names`` /
``weight_names`` attributes and the Keras-3 ``layers/<name>/vars``
group), for a mini ConvBN stack, a depthwise-separable net and
``multigriddet_tiny``.  Each file goes through the JAX
``port_keras_weights`` into flax and across ``flax_to_state_dict``, and
through the port's ``port_keras_weights`` straight into the torch model,
which starts from the same flax initial weights.  Every tensor must be
bit-equal and the audits (loaded and mismatched units, the counts of
convs and BatchNorms on both sides) must agree.

The files list layers as Keras does, in topological order, which is not
the execution order: the biased predict convs are written last, so
matching has to go by shape class.
"""

import re

import flax.linen as fnn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multigriddet_tpu.models import create_model as jax_create_model
from multigriddet_tpu.models import layers as jlayers
from multigriddet_tpu.models.porting import module_call_order as \
    jax_call_order
from multigriddet_tpu.models.porting import port_keras_weights as \
    jax_port
from multigriddet_tpu_torch.models import (create_model, flax_to_state_dict,
                                           load_flax_variables,
                                           module_call_order,
                                           port_keras_weights)
from multigriddet_tpu_torch.models.layers import (ConvBN, PredictConv,
                                                  SeparableConvBN,
                                                  auto_name)

HW = (16, 16)


class JaxMini(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = jlayers.ConvBN(8, 3)(x, train)
        x = jlayers.ConvBN(16, 3, strides=2)(x, train)
        return jlayers.PredictConv(4)(x)


class JaxMiniSeparable(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        x = jlayers.ConvBN(8, 3)(x, train)
        x = jlayers.SeparableConvBN(16, 3)(x, train)
        return jlayers.PredictConv(4)(x)


class Mini(nn.Module):
    def __init__(self, separable=False):
        super().__init__()
        auto_name(self, ConvBN(3, 8, 3))
        if separable:
            auto_name(self, SeparableConvBN(8, 16, 3))
        else:
            auto_name(self, ConvBN(8, 16, 3, strides=2))
        auto_name(self, PredictConv(16, 4))

    def forward(self, x, train=None):
        x = x.permute(0, 3, 1, 2)
        for m in self.children():
            x = m(x, train) if not isinstance(m, PredictConv) else m(x)
        return x


def _models(which):
    """(flax module, its variables, the port's model with the same
    initial weights, canvas)."""
    if which == 'tiny':
        jm = jax_create_model('multigriddet_tiny', num_classes=3)
        tm = create_model('multigriddet_tiny', num_classes=3)
        hw = (64, 64)
    else:
        sep = which == 'separable'
        jm = JaxMiniSeparable() if sep else JaxMini()
        tm = Mini(separable=sep).eval()
        hw = HW
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False))()
    load_flax_variables(tm, variables['params'], variables['batch_stats'])
    return jm, variables, tm, hw


def _keras_units(jm, variables, hw, rng, drop_last_conv_bn=False):
    """Keras-style layers ``(name, arrays)`` for the flax model, from
    seeded arrays: plain convs ``conv2d_N``, depthwise ones
    ``depthwise_conv2d_N`` with Keras's ``(k, k, C, 1)`` kernel,
    BatchNorms ``batch_normalization_N``; predict convs last."""
    params = variables['params']
    counters = {}

    def name(kind):
        n = counters.get(kind, 0)
        counters[kind] = n + 1
        return kind if n == 0 else f'{kind}_{n}'

    body, predicts = [], []
    for path in jax_call_order(jm, hw):
        node = params
        for p in path:
            node = node[p]
        if 'kernel' in node:
            shape = node['kernel'].shape
            dw = shape[2] == 1 and shape[3] > 1
            if dw:
                shape = (shape[0], shape[1], shape[3], 1)
            arrays = {'kernel': rng.normal(0, 0.3, shape)}
            if 'bias' in node:
                arrays['bias'] = rng.normal(0, 0.1, node['bias'].shape)
                predicts.append((None, arrays))
            else:
                body.append((name('depthwise_conv2d' if dw else 'conv2d'),
                             arrays))
        else:
            c = node['scale'].shape
            body.append((name('batch_normalization'), {
                'gamma': rng.uniform(0.8, 1.2, c),
                'beta': rng.normal(0, 0.1, c),
                'moving_mean': rng.normal(0, 0.2, c),
                'moving_variance': rng.uniform(0.5, 1.5, c)}))
    if drop_last_conv_bn:
        body = body[:-2]
    units = body + [(name('conv2d'), a) for _, a in predicts]
    return [(n, {k: v.astype(np.float32) for k, v in a.items()})
            for n, a in units]


def _write_h5(path, units, layout):
    with h5py.File(path, 'w') as f:
        if layout == 'legacy':
            f.attrs['layer_names'] = np.array([n.encode() for n, _ in units])
            for lname, arrays in units:
                grp = f.create_group(lname)
                grp.attrs['weight_names'] = np.array(
                    [f'{lname}/{w}:0'.encode() for w in arrays])
                for w, arr in arrays.items():
                    grp.create_dataset(f'{lname}/{w}:0', data=arr)
        else:
            layers = f.create_group('layers')
            for lname, arrays in units:
                vars_ = layers.create_group(lname).create_group('vars')
                for i, arr in enumerate(arrays.values()):
                    vars_.create_dataset(str(i), data=arr)


AUDIT = re.compile(r'Ported (\d+) units from .* \((\d+) shape mismatches; '
                   r'flax: (\d+) convs / (\d+) bns, h5: (\d+) convs / '
                   r'(\d+) bns\)')


@pytest.mark.parametrize('layout', ['legacy', 'keras3'])
@pytest.mark.parametrize('which', ['mini', 'separable', 'tiny',
                                   'mini_missing'])
def test_port_equals_jax_port_then_bridge(which, layout, tmp_path, capsys):
    jm, variables, tm, hw = _models(which.replace('_missing', ''))
    units = _keras_units(jm, variables, hw, np.random.RandomState(7),
                         drop_last_conv_bn=which.endswith('_missing'))
    path = str(tmp_path / f'{which}.h5')
    _write_h5(path, units, layout)

    ported = jax_port(path, variables, model=jm, input_hw=hw)
    jax_line = capsys.readouterr().out
    want = flax_to_state_dict(ported['params'], ported['batch_stats'])
    audit = port_keras_weights(path, tm, input_hw=hw)

    got = tm.state_dict()
    assert set(want) == {k for k in got
                         if not k.endswith('num_batches_tracked')}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    m = AUDIT.search(jax_line)
    assert m, jax_line
    assert [int(g) for g in m.groups()] == [
        audit['loaded'], audit['mismatched'], audit['model_convs'],
        audit['model_bns'], audit['h5_convs'], audit['h5_bns']]
    if which.endswith('_missing'):
        assert audit['mismatched'] == 1
    else:
        assert audit['mismatched'] == 0
        assert audit['loaded'] == audit['model_convs'] + audit['model_bns']
        # every array of the file landed in the model
        first = next(a for n, a in units if n == 'conv2d')['kernel']
        assert any(np.array_equal(v.numpy(), first.transpose(3, 2, 0, 1))
                   for v in got.values() if v.dim() == 4)


@pytest.mark.parametrize('name', ['multigriddet_resnet',
                                  'multigriddet_darknet_panet'])
def test_call_order_equals_jax(name):
    """The traced order of the deepest presets equals the JAX
    ``module_call_order`` (flax paths joined by dots)."""
    jm = jax_create_model(name, num_classes=3)
    tm = create_model(name, num_classes=3)
    jorder = ['.'.join(p) for p in jax_call_order(jm, (32, 32))]
    assert [n for n, _ in module_call_order(tm, (32, 32))] == jorder


def test_call_order_is_execution_order_not_registration():
    """A block registered before the block that runs first: the order
    follows the run, with each block's own conv before its BatchNorm."""

    class Swapped(nn.Module):
        def __init__(self):
            super().__init__()
            self.late = ConvBN(8, 8, 1)
            self.early = ConvBN(3, 8, 3)

        def forward(self, x, train=None):
            return self.late(self.early(x.permute(0, 3, 1, 2), train),
                             train)

    order = [n for n, _ in module_call_order(Swapped(), HW)]
    assert order == ['early.Conv_0', 'early.BatchNorm_0', 'late.Conv_0',
                     'late.BatchNorm_0']
