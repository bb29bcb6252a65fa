"""The rest of the model zoo and activation checkpointing against the flax
models, on the CPU in float32.

The same seeded numpy weights (flax layout, ``random_flax_variables``)
and numpy inputs go through the flax modules (un-jitted: a full model's
first compile costs minutes on a small host) and the port's.

* **Blocks** at narrow widths, eval and train mode: outputs, the batch
  statistics flax returns with ``mutable=['batch_stats']``, and the
  gradient of a sum of squares (of the outputs less a fixed offset) for
  every parameter.  Outputs and
  statistics within 1e-5 of max(1, largest |value|); gradients within 1e-4
  of each tensor's largest |gradient| (the frameworks sum in different
  orders; measured at most 3e-6 and 8e-6).
* **Presets** (all six) at full width on a 64x64 canvas with JAX's default
  ``s2d_stem``: eval logits within ``LOGIT_RTOL`` 1e-5 of the largest
  magnitude; train-mode logits within ``TRAIN_RTOL`` (3e-3, PANet 2e-2:
  JAX's float32 forward is itself that far from float64 there) and batch
  statistics within ``STATS_RTOL`` 5e-4, at b4; the JAX
  ``eval_shape`` tree maps onto every ``state_dict`` key with nothing
  left over.  Full-depth gradients are not held here: at a random init
  float32 gradients through train-mode BatchNorm are rounding noise
  (ROADMAP Queue 3); ``chip_smoke.py`` holds them in float64.
* **Custom composition** (JAX ``tests/test_models.py:53-93``), the
  registry, the config's ``model.type: custom``, **remat** and one
  trainer epoch for ``multigriddet_mobile`` and a custom composition.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from multigriddet_tpu.config import \
    build_model_from_config as jax_build_from_config
from multigriddet_tpu.models import build_custom as jax_build_custom
from multigriddet_tpu.models import create_model as jax_create_model
from multigriddet_tpu.models import darknet as jdarknet
from multigriddet_tpu.models import head as jhead
from multigriddet_tpu.models import layers as jlayers
from multigriddet_tpu.models import list_components as jax_list_components
from multigriddet_tpu.models import neck as jneck
from multigriddet_tpu.models import resnet as jresnet
from multigriddet_tpu_torch.config import build_model_from_config
from multigriddet_tpu_torch.evaluation import MultiGridEvaluator
from multigriddet_tpu_torch.inference import MultiGridInference
from multigriddet_tpu_torch.models import (build_custom, create_model,
                                           flax_to_state_dict, get_backbone,
                                           get_head, get_neck,
                                           list_available_models,
                                           list_components,
                                           load_flax_variables,
                                           random_flax_variables,
                                           state_dict_to_flax)
from multigriddet_tpu_torch.models import darknet, head, layers, neck, resnet
from multigriddet_tpu_torch.training import MultiGridTrainer, save_params

LOGIT_RTOL = 1e-5
# train-mode logits, of the largest |logit|, at b4 @64: JAX's own float32
# forward lies 1.8e-4 (mobile) to 7.5e-4 (CSP), 9.5e-4 (ResNet) and
# 5.7e-3 (PANet) from a float64 forward of the same weights, the port's
# 1.3e-5 to 4.0e-4: the batch variance E[x^2] - E[x]^2 cancels on the 2x2
# maps (16 samples a channel), deepest in PANet's coarse paths
TRAIN_RTOL = {'multigriddet_darknet_spp': 3e-3,
              'multigriddet_darknet_lite': 3e-3,
              'multigriddet_csp_darknet': 3e-3,
              'multigriddet_darknet_panet': 2e-2,
              'multigriddet_resnet': 3e-3,
              'multigriddet_mobile': 3e-3}
# running statistics after one train-mode forward, of max(1, |value|):
# measured at most 1.03e-4 (ResNet)
STATS_RTOL = 5e-4
BATCH = 4
BLOCK_RTOL = 1e-5
GRAD_RTOL = 1e-4
PRESETS = ['multigriddet_darknet_spp', 'multigriddet_darknet_lite',
           'multigriddet_csp_darknet', 'multigriddet_darknet_panet',
           'multigriddet_resnet', 'multigriddet_mobile']


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol, what=''):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())),
        err_msg=what)


# ---------------------------------------------------------------------------
# blocks at narrow widths
# ---------------------------------------------------------------------------

def _taps(rng, batch=2, widths=(8, 12, 16), size=8):
    return tuple(rng.randn(batch, size >> i, size >> i, c).astype(np.float32)
                 for i, c in enumerate(widths))


def _block_cases():
    """(id, the port block's constructor, flax block, NHWC input(s))."""
    rng = np.random.RandomState(0)
    P = functools.partial

    def img(h, w, c):
        return rng.randn(2, h, w, c).astype(np.float32)
    cases = []
    for act in ('leaky', 'mish', 'relu', 'linear'):
        cases.append((f'convbn-{act}', P(layers.ConvBN, 5, 7, 3, act=act),
                      jlayers.ConvBN(7, 3, act=act), img(9, 11, 5)))
    for s in (1, 2):
        cases.append((f'separable-s{s}',
                      P(layers.SeparableConvBN, 6, 8, 3, strides=s),
                      jlayers.SeparableConvBN(8, 3, strides=s),
                      img(10, 9, 6)))
    for k, hw in ((3, (10, 12)), (3, (9, 11)), (1, (9, 11))):
        cases.append((f'rnconvbn-k{k}-s2-{hw[0]}x{hw[1]}',
                      P(resnet._RNConvBN, 5, 6, k, 2),
                      jresnet._RNConvBN(6, k, 2), img(*hw, 5)))
    cases.append(('resnet-bottleneck-shortcut',
                  P(resnet._Bottleneck, 8, 4, 2), jresnet._Bottleneck(4, 2),
                  img(9, 10, 8)))
    cases.append(('resnet-bottleneck-identity',
                  P(resnet._Bottleneck, 16, 4, 1), jresnet._Bottleneck(4, 1),
                  img(6, 7, 16)))
    cases.append(('csp-first', P(darknet._CSPStage, 6, 8, 1, first=True),
                  jdarknet._CSPStage(8, 1, first=True), img(10, 10, 6)))
    cases.append(('csp-stage', P(darknet._CSPStage, 8, 12, 2),
                  jdarknet._CSPStage(12, 2), img(9, 11, 8)))
    cases.append(('fiveconv', P(head._FiveConv, 6, 4), jhead._FiveConv(4),
                  img(5, 6, 6)))
    cases.append(('fpn', P(neck.MultiGridFPN, (8, 12, 16), (20, 12, 8)),
                  jneck.MultiGridFPN((20, 12, 8)), _taps(rng)))
    return cases


BLOCKS = _block_cases()


def _offset(shape):
    """A fixed offset for the blocks' sum of squares: a train-mode
    BatchNorm with a linear activation normalizes away every direction
    of its input that a plain sum of squares sees, and leaves gradients
    of rounding noise."""
    return np.random.RandomState(7).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', BLOCKS, ids=[c[0] for c in BLOCKS])
def test_block_matches_flax(case, train):
    """Outputs, batch statistics and parameter gradients of one block."""
    _, make, jblock, x = case
    block = make()
    params, stats = random_flax_variables(block, seed=3)
    load_flax_variables(block, params, stats)
    taps = isinstance(x, tuple)

    def loss_fn(p):
        out, mut = jblock.apply(
            {'params': p, 'batch_stats': stats},
            tuple(map(jnp.asarray, x)) if taps else jnp.asarray(x),
            train, mutable=['batch_stats'])
        outs = out if taps else (out,)
        return sum(jnp.sum(jnp.square(o - _offset(o.shape)))
                   for o in outs), (outs, mut)
    (_, (want, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    got = block(tuple(map(_nchw, x)) if taps else _nchw(x), train)
    got = got if taps else (got,)
    sum((o.permute(0, 2, 3, 1) - torch.from_numpy(_offset(o.permute(
        0, 2, 3, 1).shape))).square().sum() for o in got).backward()
    for a, b in zip(want, got):
        _close(_nhwc(b), a, BLOCK_RTOL, 'output')
    want_stats = flax_to_state_dict({}, jax.tree_util.tree_map(
        np.asarray, mut['batch_stats']))
    sd = block.state_dict()
    assert want_stats and set(want_stats) == {
        k for k in sd if k.endswith(('running_mean', 'running_var'))}
    for k, w in want_stats.items():
        _close(sd[k].numpy(), w.numpy(), BLOCK_RTOL, k)
    want_grads = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           grads))
    named = dict(block.named_parameters())
    assert set(want_grads) == set(named)
    for k, w in want_grads.items():
        w = w.numpy()
        np.testing.assert_allclose(
            named[k].grad.numpy(), w, rtol=0,
            atol=GRAD_RTOL * max(float(np.abs(w).max()), 1e-30), err_msg=k)


@pytest.mark.parametrize('hw', [(13, 13), (8, 11)])
def test_spp_pools_13_9_5_then_identity(hw):
    """-inf padding: an all-negative map pools to its own values at the
    border, never to the pad."""
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32) - 5.0
    want = jlayers.spp(jnp.asarray(x))
    got = layers.spp(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(_nhwc(got)[..., -3:], x)


def test_mish_follows_the_jax_definition():
    x = np.linspace(-30, 30, 2001).astype(np.float32)
    want = np.asarray(jlayers.mish(jnp.asarray(x)))
    got = layers.mish(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# presets at full width
# ---------------------------------------------------------------------------

def _jax_tree(jmodel, hw=(64, 64)):
    """The flax model's variables as zeros of ``eval_shape``'s shapes."""
    shapes = jax.eval_shape(
        lambda k, x: jmodel.init(k, x, train=False), jax.random.PRNGKey(0),
        jnp.zeros((1, *hw, 3)))
    return {c: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[c])
        for c in ('params', 'batch_stats')}


def _assert_bridge_covers(model, jmodel):
    """Every flax leaf maps onto a ``state_dict`` key of its shape, and
    every key (but ``num_batches_tracked``) is reached."""
    tree = _jax_tree(jmodel)
    load_flax_variables(model, tree['params'], tree['batch_stats'])
    mapped = flax_to_state_dict(tree['params'], tree['batch_stats'])
    keys = {k for k in model.state_dict()
            if not k.endswith('num_batches_tracked')}
    assert set(mapped) == keys
    return tree


@pytest.mark.parametrize('name', PRESETS)
def test_preset_matches_jax(name):
    """Eval logits, then train-mode logits and batch statistics, from the
    same weights; and the flax tree covers every key."""
    model = create_model(name, num_anchors=(3, 3, 3), num_classes=80)
    jmodel = jax_create_model(name, num_anchors=(3, 3, 3), num_classes=80)
    _assert_bridge_covers(model, jmodel)
    params, stats = random_flax_variables(model, seed=11)
    load_flax_variables(model, params, stats)
    x = np.random.RandomState(4).rand(BATCH, 64, 64, 3).astype(np.float32)
    variables = {'params': params, 'batch_stats': stats}
    with jax.disable_jit():
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
        want_train, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                                       mutable=['batch_stats'])
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        assert [tuple(g.shape) for g in got] == [
            (BATCH, 2, 2, 88), (BATCH, 4, 4, 88), (BATCH, 8, 8, 88)]
        for a, b in zip(want, got):
            _close(b.numpy(), a, LOGIT_RTOL, 'eval logits')
        got_train = model(torch.from_numpy(x), train=True)
    for a, b in zip(want_train, got_train):
        _close(b.numpy(), a, TRAIN_RTOL[name], 'train logits')
    sd = model.state_dict()
    for k, w in flax_to_state_dict({}, jax.tree_util.tree_map(
            np.asarray, mut['batch_stats'])).items():
        _close(sd[k].numpy(), w.numpy(), STATS_RTOL, k)


def test_resnet_and_mobile_auto_names_and_depthwise_layout():
    """flax's construction-order names: ResNet's shortcut comes first, its
    ``_Bottleneck`` count runs 0-15 over the four stages; MobileDarknet's
    convs are ``ConvBN_0..5`` and its residuals ``SeparableConvBN_0..7``;
    the lite bottleneck's 3x3 is ``SeparableConvBN_0`` and its last 1x1
    ``ConvBN_1``.  A depthwise HWIO ``(k, k, 1, C)`` kernel becomes OIHW
    ``(C, 1, k, k)`` and back."""
    rn = create_model('multigriddet_resnet', num_classes=2)
    keys = rn.state_dict()
    assert 'backbone._Bottleneck_15._RNConvBN_2.Conv_0.weight' in keys
    assert 'backbone._Bottleneck_16._RNConvBN_0.Conv_0.weight' not in keys
    assert keys['backbone._Bottleneck_0._RNConvBN_0.Conv_0.weight'].shape \
        == (256, 64, 1, 1)                                  # the shortcut
    assert 'backbone._Bottleneck_1._RNConvBN_3.Conv_0.weight' not in keys
    mobile = create_model('multigriddet_mobile', num_classes=2)
    names = set(mobile.backbone._modules)
    assert names == {f'ConvBN_{i}' for i in range(6)} | {
        f'SeparableConvBN_{i}' for i in range(8)}
    assert set(mobile.head._ScaleHead_0._Bottleneck_0._modules) == {
        'ConvBN_0', 'SeparableConvBN_0', 'ConvBN_1'}
    spp = create_model('multigriddet_darknet_spp', num_classes=2)
    assert set(spp.head._ScaleHead_0._Bottleneck_0._modules) == {
        f'ConvBN_{i}' for i in range(4)}
    tree = _jax_tree(jax_create_model('multigriddet_mobile', num_classes=2))
    w = np.random.RandomState(0).randn(3, 3, 1, 64).astype(np.float32)
    tree['params']['backbone']['SeparableConvBN_1']['Conv_0']['kernel'] = w
    load_flax_variables(mobile, tree['params'], tree['batch_stats'])
    dw = mobile.state_dict()['backbone.SeparableConvBN_1.Conv_0.weight']
    np.testing.assert_array_equal(dw.numpy(), w.transpose(3, 2, 0, 1))
    back, _ = state_dict_to_flax(mobile.state_dict())
    np.testing.assert_array_equal(
        back['backbone']['SeparableConvBN_1']['Conv_0']['kernel'], w)


# ---------------------------------------------------------------------------
# registry, custom composition, config
# ---------------------------------------------------------------------------

def test_registry_equals_jax_and_unknown_names_raise():
    assert list_components() == jax_list_components()
    assert list_available_models() == list_components()
    for fn, what in ((create_model, 'model'), (get_backbone, 'backbone'),
                     (get_neck, 'neck'), (get_head, 'head')):
        with pytest.raises(KeyError, match=f'Unknown {what}'):
            fn('nope')
    with pytest.raises(KeyError, match='Unknown backbone'):
        build_custom('nope')
    with pytest.raises(KeyError, match='Unknown head'):
        build_custom('darknet53', 'nope')
    with pytest.raises(KeyError, match='Unknown neck'):
        build_custom('darknet53', neck_name='nope')


CUSTOM = [
    ('csp-lite', dict(backbone_name='csp_darknet53',
                      head_name='multigrid_lite')),
    ('csp-fpn', dict(backbone_name='csp_darknet53', head_name='multigrid',
                     neck_name='multigrid_fpn',
                     neck_kwargs={'channels': (64, 48, 32)})),
    ('mobile-fpn-panet', dict(backbone_name='mobile_darknet',
                              head_name='panet', neck_name='multigrid_fpn',
                              neck_kwargs={'channels': (64, 48, 32)})),
]


def _assert_custom_matches(model, jmodel, seed):
    _assert_bridge_covers(model, jmodel)
    params, stats = random_flax_variables(model, seed=seed)
    load_flax_variables(model, params, stats)
    x = np.random.RandomState(seed).rand(BATCH, 64, 64, 3).astype(
        np.float32)
    with jax.disable_jit():
        want = jmodel.apply({'params': params, 'batch_stats': stats},
                            jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for scale, (a, b) in enumerate(zip(want, got)):
        assert tuple(b.shape) == (BATCH, 2 << scale, 2 << scale, 2 + 3 + 5)
        _close(b.numpy(), a, LOGIT_RTOL, 'logits')


@pytest.mark.parametrize('kwargs', [c[1] for c in CUSTOM],
                         ids=[c[0] for c in CUSTOM])
def test_custom_composition_matches_jax(kwargs):
    """The compositions of the JAX model tests (and a neck before the
    PANet head): the head's widths follow the neck's ``out_channels``."""
    model = build_custom(num_classes=2, **kwargs)
    assert not model.training
    assert (model.neck is not None) == ('neck_name' in kwargs)
    _assert_custom_matches(model, jax_build_custom(num_classes=2, **kwargs),
                           seed=5)


def test_custom_config_mode_with_a_neck_matches_jax():
    """``model.type: custom`` through both builders; ``remat`` and
    ``bn_momentum`` are not read in custom mode."""
    cfg = {'model': {'type': 'custom', 'preset': {
               'num_classes': 2, 'input_shape': [64, 64, 3],
               'bn_momentum': 0.9},
           'custom': {'backbone': {'type': 'resnet50'},
                      'neck': {'type': 'multigrid_fpn',
                               'channels': [64, 48, 32]},
                      'head': {'type': 'multigrid_lite'}}},
           'environment': {'remat': 'full'}}
    model, spec = build_model_from_config(cfg)
    jmodel, jspec = jax_build_from_config(cfg)
    assert spec['mode'] == jspec['mode'] == 'custom'
    assert model.remat is None and model.neck.channels == (64, 48, 32)
    assert model.neck.ConvBN_0.bn_momentum == 0.99
    _assert_custom_matches(model, jmodel, seed=6)


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

def _step(remat, name='multigriddet_tiny', seed=0):
    """One train-mode forward + backward of a sum of squares."""
    model = create_model(name, num_anchors=(1, 1, 1), num_classes=2,
                         remat=remat).train()
    load_flax_variables(model, *random_flax_variables(model, seed=seed))
    x = torch.from_numpy(np.random.RandomState(seed).rand(2, 64, 64, 3)
                         .astype(np.float32))
    loss = sum(o.square().sum() for o in model(x))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(('running_mean', 'running_var'))}
    return float(loss.detach()), grads, stats


@pytest.mark.parametrize('remat', [True, 'full'])
def test_remat_step_equals_the_plain_step(remat):
    """Loss, every gradient and every running statistic bit-equal to the
    plain step: the recompute in the backward does not move the running
    statistics a second time (a recompute that did would leave
    ``0.99^2 old + ...`` in every backbone BatchNorm)."""
    loss, grads, stats = _step(None)
    rloss, rgrads, rstats = _step(remat)
    assert rloss == loss
    for k, g in grads.items():
        assert torch.equal(rgrads[k], g), k
    for k, s in stats.items():
        assert torch.equal(rstats[k], s), k


@pytest.mark.parametrize('remat', [True, 'full'])
def test_remat_recompute_would_move_the_statistics_without_the_guard(
        monkeypatch, remat):
    """The check above has teeth: with the recompute's guard removed, the
    backbone's running statistics move twice."""
    import contextlib
    monkeypatch.setattr(layers, 'no_stat_updates', contextlib.nullcontext)
    _, _, stats = _step(None)
    _, _, rstats = _step(remat)
    moved = [k for k, s in stats.items() if not torch.equal(rstats[k], s)]
    assert moved and all(k.startswith('backbone.') for k in moved)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.conv = self.rsqrt = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.conv += func is torch.ops.aten.convolution.default
        self.rsqrt += func is torch.ops.aten.rsqrt.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('name', ['multigriddet_tiny', 'multigriddet_mobile'])
def test_what_each_remat_mode_recomputes(name):
    """In the backward, the selective mode re-runs every backbone
    BatchNorm (one ``rsqrt`` each) and no conv, the separable convs'
    included; ``'full'`` re-runs the backbone's convs as well; the plain
    step re-runs nothing."""
    for remat in (None, True, 'full'):
        model = create_model(name, remat=remat).train()
        bns = sum(k.endswith('running_var')
                  for k in model.backbone.state_dict())
        convs = sum(isinstance(m, torch.nn.Conv2d)
                    for m in model.backbone.modules())
        loss = sum(o.sum() for o in model(torch.rand(2, 64, 64, 3)))
        counter = _CountOps()
        with counter:
            loss.backward()
        want = {None: (0, 0), True: (0, bns), 'full': (convs, bns)}[remat]
        assert (counter.conv, counter.rsqrt) == want, remat


@pytest.mark.parametrize('remat', [True, 'full'])
def test_remat_gradients_match_jax(remat):
    """The JAX ``test_remat_backbone_grads_match`` setting (tiny, one anchor
    a scale, 2 classes, eval-mode BatchNorm, a sum of squares): the port's
    checkpointed gradients against JAX's checkpointed gradients."""
    model = create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                         num_classes=2, remat=remat)
    params, stats = random_flax_variables(model, seed=8)
    load_flax_variables(model, params, stats)
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                              num_classes=2, remat=remat)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)

    def loss_fn(p):
        outs = jmodel.apply({'params': p, 'batch_stats': stats},
                            jnp.asarray(x), train=False)
        return sum(jnp.sum(o ** 2) for o in outs)
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = sum(o.square().sum() for o in model(torch.from_numpy(x)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    for k, w in flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          want)).items():
        w = w.numpy()
        np.testing.assert_allclose(
            named[k].grad.numpy(), w, rtol=0,
            atol=GRAD_RTOL * max(float(np.abs(w).max()), 1e-30), err_msg=k)


# ---------------------------------------------------------------------------
# the trainer through the config path
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('zoo')
    rng = np.random.RandomState(9)
    lines = []
    for i in range(8):
        img = Image.fromarray(rng.randint(0, 255, (72, 88, 3)).astype(
            'uint8'))
        x1, y1 = rng.randint(4, 30), rng.randint(4, 25)
        x2, y2 = x1 + rng.randint(20, 50), y1 + rng.randint(20, 40)
        ImageDraw.Draw(img).rectangle(
            [x1, y1, x2, y2], fill=(250, 20, 20) if i % 2 else (20, 250, 20))
        p = root / f'img_{i}.jpg'
        img.save(p)
        lines.append(f'{p} {x1},{y1},{x2},{y2},{i % 2}')
    (root / 'train.txt').write_text('\n'.join(lines) + '\n')
    (root / 'classes.txt').write_text('red\ngreen\n')
    (root / 'anchors.txt').write_text('40,40\n20,20\n10,10\n')
    return root


ZOO_MODELS = {
    'mobile': {'type': 'preset'},
    'custom-mobile-fpn-panet': {'type': 'custom', 'custom': {
        'backbone': {'type': 'mobile_darknet'},
        'neck': {'type': 'multigrid_fpn', 'channels': [64, 48, 32]},
        'head': {'type': 'panet'}}},
}


@pytest.mark.parametrize('which', list(ZOO_MODELS))
def test_trainer_epoch_on_the_cpu(dataset, tmp_path, which):
    """One epoch of two steps through ``MultiGridTrainer`` from a config
    (``multigriddet_mobile`` with ``remat: true``, or a custom composition)
    from a seeded weights file: finite losses, the head's predict convs
    and the backbone's statistics moved; the export loads, serves through
    ``MultiGridInference`` and evaluates through ``MultiGridEvaluator``."""
    model_cfg = dict(ZOO_MODELS[which])
    model_cfg['preset'] = {
        'architecture': 'multigriddet_mobile', 'num_classes': 2,
        'input_shape': [64, 64, 3],
        'anchors_path': str(dataset / 'anchors.txt'),
        'classes_path': str(dataset / 'classes.txt')}
    cfg = {'model': model_cfg,
           'data': {'train_annotation': str(dataset / 'train.txt'),
                    'val_annotation': str(dataset / 'train.txt')},
           'data_loader': {'num_workers': 2},
           'environment': {'remat': True},
           'training': {'batch_size': 4, 'epochs': 1, 'transfer_epochs': 0,
                        'learning_rate': 1e-3,
                        'augmentation': {'enabled': False,
                                         'max_boxes_per_image': 10}},
           'optimizer': {'type': 'adam'},
           'resume': {'weights_path': str(tmp_path / 'init.msgpack')},
           'callbacks': {'checkpoint': {'save_dir': str(tmp_path / 'ckpt')}},
           'output': {'log_dir': str(tmp_path / 'logs'),
                      'model_dir': str(tmp_path / 'models')}}
    init, _ = build_model_from_config(cfg)
    params, stats = random_flax_variables(init, seed=2)
    save_params(str(tmp_path / 'init.msgpack'),
                {'params': params, 'batch_stats': stats})
    trainer = MultiGridTrainer(cfg, device='cpu')
    history = trainer.train()
    assert len(history) == 1 and history[0]['steps'] == 2
    assert all(math.isfinite(v) for v in history[0].values()
               if isinstance(v, float))
    assert trainer.model.remat == ('conv' if which == 'mobile' else None)
    before = flax_to_state_dict(params, stats)
    export = create_model('multigriddet_mobile', num_anchors=(1, 1, 1),
                          num_classes=2) if which == 'mobile' else \
        build_model_from_config(cfg)[0]
    from multigriddet_tpu_torch.models import load_weights_flexible
    load_weights_flexible(str(tmp_path / 'models' / 'final_model.msgpack'),
                          export)
    after = export.state_dict()

    def moved(k):
        return not torch.equal(after[k], before[k])
    assert all(moved(k) for k in before if 'PredictConv' in k)
    assert any(moved(k) for k in before
               if k.startswith('backbone.') and 'running_var' in k)

    # the export serves (pop-max backend) and evaluates
    final = str(tmp_path / 'models' / 'final_model.msgpack')
    engine = MultiGridInference({
        'model': cfg['model'], 'weights_path': final,
        'detection': {'confidence_threshold': 0.0,
                      'nms_backend': 'pallas_fused'}}, device='cpu')
    boxes, _, scores = engine.detect(Image.open(dataset / 'img_0.jpg'))
    assert len(boxes) and np.isfinite(scores).all()
    result = MultiGridEvaluator({
        'model': cfg['model'], 'weights_path': final,
        'environment': {'mixed_precision': False},
        'data': {'annotation': str(dataset / 'train.txt'),
                 'classes_path': str(dataset / 'classes.txt')},
        'evaluation': {'batch_size': 4, 'confidence_threshold': 0.05,
                       'max_detections': 100, 'nms_backend': 'pallas_fused',
                       'num_workers': 2, 'save_detections': False,
                       'results_dir': str(tmp_path / 'results')}},
        device='cpu').evaluate()
    assert result['num_images'] == 8 and 0.0 <= result['mAP'] <= 1.0
