"""The port's model zoo and weight bridge against the flax models.

The same seeded numpy weights (flax layout) and images go through the JAX
``model.apply(train=False)`` and the port's modules, on the CPU in float32.
Tolerances: logits agree to 1e-5 of their largest magnitude; the two
frameworks sum each convolution in a different order (measured ~1e-6
relative after Darknet53 + head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigriddet_tpu.models import create_model as jax_create_model
from multigriddet_tpu.models.layers import ConvBN as JaxConvBN
from multigriddet_tpu_torch.models import (ConvBN, create_model,
                                           flax_to_state_dict,
                                           load_flax_variables,
                                           load_weights_flexible,
                                           random_flax_variables)

LOGIT_RTOL = 1e-5


def _assert_logits_close(jax_outs, torch_outs):
    assert len(jax_outs) == len(torch_outs)
    for a, b in zip(jax_outs, torch_outs):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape and b.dtype == np.float32
        tol = LOGIT_RTOL * max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


@pytest.mark.parametrize('kernel,strides', [(3, 2), (3, 1), (1, 1)])
def test_convbn_padding_matches_flax(kernel, strides):
    """Stride-2 convs pad top/left by one then run VALID; stride 1 is SAME."""
    cin, cout = 5, 7
    block = ConvBN(cin, cout, kernel, strides).eval()
    params, stats = random_flax_variables(block, seed=3)
    load_flax_variables(block, params, stats)
    x = np.random.RandomState(0).randn(2, 9, 11, cin).astype(np.float32)
    want = JaxConvBN(cout, kernel, strides=strides).apply(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x),
        train=False)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_tiny_logits_match_jax():
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=1)
    load_flax_variables(model, params, stats)
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                              num_classes=2)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 2, 2, 10), (2, 4, 4, 10),
                                            (2, 8, 8, 10)]
    _assert_logits_close(want, got)


@pytest.mark.parametrize('s2d_stem', [True, False])
def test_darknet_logits_match_jax(s2d_stem):
    """Darknet53 + MultiGridHead at full width on a 64x64 canvas.  The port
    runs the plain 3x3 stem; the JAX space-to-depth stem is the same
    function of the same parameters.  JAX runs un-jitted: the full model's
    first compile costs minutes on a small host."""
    model = create_model('multigriddet_darknet', num_anchors=(3, 3, 3),
                         num_classes=80)
    params, stats = random_flax_variables(model, seed=2)
    load_flax_variables(model, params, stats)
    jmodel = jax_create_model('multigriddet_darknet', num_anchors=(3, 3, 3),
                              num_classes=80, s2d_stem=s2d_stem)
    x = np.random.RandomState(1).rand(1, 64, 64, 3).astype(np.float32)
    with jax.disable_jit():
        want = jmodel.apply({'params': params, 'batch_stats': stats},
                            jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(1, 2, 2, 88), (1, 4, 4, 88),
                                            (1, 8, 8, 88)]
    _assert_logits_close(want, got)


def test_bridge_matches_flax_init_tree():
    """The flax tree of the JAX model maps onto every key of the port's
    model (HWIO kernels become OIHW), with nothing left over."""
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                              num_classes=2)
    variables = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    load_flax_variables(model, variables['params'], variables['batch_stats'])
    sd = model.state_dict()
    kernel = variables['params']['head']['_ScaleHead_1']['ConvBN_0'][
        'Conv_0']['kernel']
    np.testing.assert_array_equal(
        sd['head._ScaleHead_1.ConvBN_0.Conv_0.weight'].numpy(),
        kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd['backbone.ConvBN_2.BatchNorm_0.running_var'].numpy(),
        variables['batch_stats']['backbone']['ConvBN_2']['BatchNorm_0'][
            'var'])


def test_bridge_rejects_missing_and_leftover_keys():
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=0)
    del params['head']['ConvBN_1']
    with pytest.raises(KeyError, match='missing'):
        load_flax_variables(model, params, stats)
    params, stats = random_flax_variables(model, seed=0)
    params['head']['extra'] = {'Conv_0': {'kernel': np.zeros((1, 1, 1, 1))}}
    with pytest.raises(KeyError, match='leftover'):
        load_flax_variables(model, params, stats)
    params, stats = random_flax_variables(model, seed=0)
    params['backbone']['ConvBN_0']['Conv_0']['kernel'] = np.zeros(
        (3, 3, 3, 5), np.float32)
    with pytest.raises(ValueError, match='shape'):
        load_flax_variables(model, params, stats)


@pytest.mark.parametrize('bundle', [True, False])
def test_load_weights_flexible_reads_jax_msgpack(tmp_path, bundle):
    """Files written by the JAX package's ``save_params`` (flax msgpack): the
    serving bundle and a bare params tree both load."""
    from multigriddet_tpu.training.checkpoint import save_params
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=5)
    path = str(tmp_path / 'w.msgpack')
    save_params(path, {'params': params, 'batch_stats': stats} if bundle
                else params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_weights_flexible(path, model)
    want = flax_to_state_dict(params, stats if bundle else None)
    sd = model.state_dict()
    for k, v in sd.items():
        if k in want:
            np.testing.assert_array_equal(v.numpy(), want[k].numpy())
        elif not k.endswith('num_batches_tracked'):
            # bare params: running statistics keep their values
            assert not bundle
            np.testing.assert_array_equal(v.numpy(), before[k].numpy())


def test_tiny_bf16_stays_within_bound_of_jax():
    """Serving computes the convs in bfloat16 (f32 parameters, f32 predict
    output).  bfloat16 keeps 8 mantissa bits, and the two frameworks round
    at different points, so the port's bf16 logits are held to 3e-2 of the
    largest f32 logit, both against JAX's bf16 model and against its own
    f32 model (measured ~0.8e-2)."""
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=2, dtype=torch.bfloat16)
    params, stats = random_flax_variables(model, seed=1)
    load_flax_variables(model, params, stats)
    model32 = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                           num_classes=2)
    load_flax_variables(model32, params, stats)
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                              num_classes=2, dtype=jnp.bfloat16)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        ref = model32(torch.from_numpy(x))
    for a, b, c in zip(want, got, ref):
        assert b.dtype == torch.float32
        bound = 3e-2 * float(c.abs().max())
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=bound)
        np.testing.assert_allclose(b.numpy(), c.numpy(), rtol=0, atol=bound)
