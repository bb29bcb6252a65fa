"""The port's train-mode model, train/eval/fused steps, optimizers, LR
schedules and BatchNorm recalibration against the JAX package.

The same seeded flax weights (``random_flax_variables``) and the same numpy
batches go through JAX (``model.apply``, ``make_train_step``,
``make_fused_train_step``, ``make_eval_step``, optax, ``calibrate_batch_
stats``) and the port, on the CPU in float32, on ``multigriddet_tiny`` at
64x64 (Darknet53 at 64x64 for the train-mode BatchNorm only).

Tolerances (the two frameworks sum convolutions and reductions in
different orders, ~1e-6 relative):
* train-mode logits: 5e-4 of the largest |logit|, and running statistics
  right after a train-mode forward, or recalibrated: 5e-4 of max(1,
  |value|) (the batch variance ``E[x^2] - E[x]^2`` cancels on the deepest
  maps; measured 1.0e-4 through Darknet53, where a float64 forward puts
  JAX 1.0e-4 and the port 3.6e-5 away); running statistics after a step:
  1e-5 of max(1, |value|);
* loss and every metric: 1e-5 relative (of max(1, |value|)) from the
  identical state, 1e-4 after an update has moved the parameters (see
  Adam below); ``num_positives`` exact;
* parameters after the steps: 2e-6 + 1e-3 x the learning rate absolute;
  Adam normalizes each gradient element, so an element whose gradient
  is at rounding level (|first moment| under 1e-3 of the tensor's
  largest) moves by the learning rate in a direction the rounding picks:
  those get 2 x the learning rate per update more;
* optimizer moments and EMA parameters: 1e-4 of the tensor's largest
  |value|;
* frozen parameters: bit-unchanged; learning rates: 1e-7 relative.
"""

import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multigriddet_tpu.config import builder as jbuilder
from multigriddet_tpu.losses import LossConfig as JLossConfig
from multigriddet_tpu.models import create_model as jax_create_model
from multigriddet_tpu.ops.encoding import encode_targets as jax_encode
from multigriddet_tpu.ops.yuv import rgb_to_yuv420_np
from multigriddet_tpu.training import calibrate as jcal
from multigriddet_tpu.training import state as jstate_mod
from multigriddet_tpu.training import steps as jsteps
from multigriddet_tpu_torch.config import builder
from multigriddet_tpu_torch.losses import LossConfig
from multigriddet_tpu_torch.models import (create_model, flax_to_state_dict,
                                           load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.training import (apply_freeze,
                                             calibrate_batch_stats,
                                             create_train_state,
                                             make_eval_step,
                                             make_fused_train_step,
                                             make_train_step)
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

HW = (64, 64)
NC = 3
ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [14, 28], [28, 14]], np.float32),
           np.array([[10, 10], [7, 14], [14, 7]], np.float32)]
# the loss block of configs/train_config.yaml
LOSS = dict(coord_scale=5.0, no_object_scale=0.5, label_smoothing=0.01,
            use_consensus_loss=True, max_gt_boxes=16)
LR = 1e-3
# train-mode logits and batch moments: the batch variance E[x^2] - E[x]^2
# cancels, and on the deepest 2x2 maps of a batch of 2 (8 samples per
# channel) the order of the sums shows through Darknet53 (measured 1.0e-4
# of the largest logit; against a float64 forward JAX is 1.0e-4 off, the
# port 3.6e-5)
TRAIN_LOGIT_RTOL = 5e-4


def _batch(seed, batch=2):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, 6, 5), np.float32)
    for b in range(batch):
        for t in range(rng.randint(2, 6)):
            w, h = rng.uniform(6, 40), rng.uniform(6, 40)
            x, y = rng.uniform(0, HW[1] - w), rng.uniform(0, HW[0] - h)
            boxes[b, t] = [x, y, x + w, y + h, rng.randint(NC)]
    pixels = rng.randint(0, 256, (batch, *HW, 3)).astype(np.uint8)
    return pixels, boxes


def _targets(boxes):
    return [np.asarray(y) for y in jax_encode(boxes, ANCHORS, NC, HW)]


@pytest.fixture(scope='module')
def weights():
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=NC)
    return random_flax_variables(model, seed=4)


@pytest.fixture(scope='module')
def jmodel():
    return jax_create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                            num_classes=NC)


def _torch_model(weights):
    model = create_model('multigriddet_tiny', num_anchors=(3, 3, 3),
                         num_classes=NC)
    load_flax_variables(model, *weights)
    return model.train()


def _close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert abs(got - want) <= rtol * max(1.0, abs(want)), (what, got, want)


def _assert_state_dict_close(model, params, stats, param_atol,
                             stat_rtol=1e-5, noise=None):
    """The port's parameters and running statistics against flax trees.

    ``noise`` = (mu tree, allowance): Adam moves an element whose gradient
    is at rounding level by the learning rate in a direction the rounding
    picks, so elements with |mu| under 1e-3 of the tensor's largest get
    ``allowance`` more."""
    want = flax_to_state_dict(params, stats)
    loose = {}
    if noise is not None:
        for k, m in flax_to_state_dict(noise[0]).items():
            m = m.abs().numpy()
            loose[k] = np.where(m < 1e-3 * max(float(m.max()), 1e-30),
                                noise[1], 0.0)
    sd = model.state_dict()
    for k, w in want.items():
        g = sd[k].numpy()
        w = w.numpy()
        if k.endswith(('running_mean', 'running_var')):
            np.testing.assert_allclose(g, w, rtol=0, atol=stat_rtol * max(
                1.0, float(np.abs(w).max())), err_msg=k)
        else:
            bad = np.abs(g - w) > param_atol + loose.get(k, 0.0)
            assert not bad.any(), (k, float(np.abs(g - w).max()),
                                   int(bad.sum()))


def _moment_trees(opt_state):
    """(first, second) moment trees of an optax state, masked leaves
    dropped: adam's (mu, nu), sgd's (trace, None)."""
    kinds = (optax.ScaleByAdamState, optax.TraceState)
    found = [(x.mu, x.nu) if isinstance(x, optax.ScaleByAdamState)
             else (x.trace, None)
             for x in jax.tree_util.tree_leaves(
                 opt_state, is_leaf=lambda x: isinstance(x, kinds))
             if isinstance(x, kinds)]
    assert len(found) == 1, found

    def clean(tree):
        if tree is None:
            return None
        flat = flax.traverse_util.flatten_dict(tree)
        return flax.traverse_util.unflatten_dict(
            {k: np.asarray(v) for k, v in flat.items()
             if hasattr(v, 'shape')})
    return tuple(clean(t) for t in found[0])


def _assert_moments_close(topt, model, opt_state, kind):
    names = {id(p): n for n, p in model.named_parameters()}
    first, second = _moment_trees(opt_state)
    keys = (('exp_avg', first), ('exp_avg_sq', second)) if kind != 'sgd' \
        else (('momentum_buffer', first),)
    for slot, tree in keys:
        want = flax_to_state_dict(tree)
        got = {names[id(p)]: s[slot] for p, s in topt.inner.state.items()}
        assert set(got) == set(want), (slot, set(got) ^ set(want))
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=0,
                atol=1e-4 * max(float(np.abs(w).max()), 1e-12),
                err_msg=f'{slot} {k}')


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('arch,s2d', [('multigriddet_tiny', None),
                                      ('multigriddet_darknet', True),
                                      ('multigriddet_darknet', False)])
def test_train_mode_forward_and_batch_stats_match_flax(arch, s2d):
    """flax ``apply(train=True, mutable=['batch_stats'])``: batch mean and
    fast variance, running statistics ``0.99 * old + 0.01 * batch`` with
    the biased variance.  JAX's space-to-depth stem (``_PhaseBN``) and
    the plain stem give the same function; the port runs the plain one."""
    nc = 80 if arch.endswith('darknet') else NC
    model = create_model(arch, num_anchors=(3, 3, 3), num_classes=nc)
    params, stats = random_flax_variables(model, seed=6)
    load_flax_variables(model, params, stats)
    kw = {} if s2d is None else {'s2d_stem': s2d}
    jm = jax_create_model(arch, num_anchors=(3, 3, 3), num_classes=nc, **kw)
    x = np.random.RandomState(2).rand(2, *HW, 3).astype(np.float32)

    def apply(v, im):
        return jm.apply(v, im, train=True, mutable=['batch_stats'])
    variables = {'params': params, 'batch_stats': stats}
    if arch.endswith('darknet'):
        with jax.disable_jit():
            want, mut = apply(variables, jnp.asarray(x))
    else:
        want, mut = jax.jit(apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=True)
    for a, b in zip(want, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=TRAIN_LOGIT_RTOL
                                   * max(1.0, float(np.abs(a).max())))
    _assert_state_dict_close(model, params,
                             jax.tree_util.tree_map(np.asarray,
                                                    mut['batch_stats']), 0,
                             TRAIN_LOGIT_RTOL)
    # inference mode is the serving path: no statistics move
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.eval()(torch.from_numpy(x))
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# one train step against JAX
# ---------------------------------------------------------------------------

def _config(opt_cfg, sched=None):
    return {'training': {'learning_rate': LR}, 'optimizer': dict(opt_cfg),
            'lr_schedule': sched or {'type': 'constant'}}


def _run_both(weights, jmodel, opt_cfg, freeze_level=0, ema_decay=None,
              accum=1, steps=2, sched=None):
    params, stats = weights
    config = _config(opt_cfg, sched)
    batches = []
    for i in range(steps):
        pixels, boxes = _batch(10 + i)
        batches.append((pixels.astype(np.float32) / 255.0, _targets(boxes)))
    # JAX, as the JAX trainer builds a stage
    jsched = jbuilder.make_lr_schedule(config, 2, 3)
    opt = jbuilder.create_optimizer_from_config(config, jsched)
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    tx = jstate_mod.partition_optimizer(opt, params, freeze_level)
    jstate = jstate_mod.create_train_state(params, stats, optax.identity())
    jstate = jstate.replace(opt_state=tx.init(params))
    if ema_decay is not None:
        jstate = jstate.replace(ema_params=jax.tree_util.tree_map(
            jnp.array, params))
    jstep = jsteps.make_train_step(
        jmodel, tx, ANCHORS, NC, HW, JLossConfig(**LOSS), donate=False,
        freeze_level=freeze_level, ema_decay=ema_decay)
    # the port
    model = _torch_model(weights)
    trainable = apply_freeze(model, freeze_level)
    topt = builder.create_optimizer_from_config(
        config, trainable, builder.make_lr_schedule(config, 2, 3), accum)
    tstate = create_train_state(model, topt, ema=ema_decay is not None)
    tstep = make_train_step(ANCHORS, NC, HW, LossConfig(**LOSS),
                            freeze_level=freeze_level, ema_decay=ema_decay)
    for i, (images, y_true) in enumerate(batches):
        jstate, jm = jstep(jstate, jnp.asarray(images), y_true)
        tstate, tm = tstep(tstate, torch.from_numpy(images),
                           [torch.from_numpy(y) for y in y_true])
        assert set(tm) == set(jm)
        for k in jm:
            _close(float(tm[k]), float(jm[k]), 1e-5 if i < accum else 1e-4,
                   k)
    assert tstate.step == int(jstate.step) == steps
    return jstate, tstate, model, topt


OPTIMIZERS = {
    'adam': {'type': 'adam'},
    'adamw': {'type': 'adamw', 'weight_decay': 0.05},
    'sgd': {'type': 'sgd'},
    'sgd_nesterov': {'type': 'sgd', 'momentum': 0.9, 'nesterov': True},
}


@pytest.mark.parametrize('name,freeze_level,ema', [
    ('adam', 0, None), ('adam', 1, None), ('adam', 2, 0.9),
    ('adamw', 0, 0.99), ('sgd', 0, None), ('sgd_nesterov', 1, None)])
def test_train_step_matches_jax(weights, jmodel, name, freeze_level, ema):
    """Two steps from identical state: loss and metrics each step, then
    parameters, BatchNorm statistics, optimizer moments and EMA; frozen
    parameters bit-unchanged.  Cosine warmup schedule (count read before
    it advances)."""
    sched = {'type': 'cosine_annealing', 'warmup_epochs': 1}
    jstate, tstate, model, topt = _run_both(
        weights, jmodel, OPTIMIZERS[name], freeze_level, ema, sched=sched)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    noise = (_moment_trees(jstate.opt_state)[0], 2 * LR * 2) \
        if name.startswith('adam') else None
    _assert_state_dict_close(model, params, stats, 2e-6 + 1e-3 * LR,
                             noise=noise)
    _assert_moments_close(topt, model, jstate.opt_state, name[:3])
    start = flax_to_state_dict(*weights)
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert bool(frozen) == (freeze_level > 0)
    for n in frozen:
        assert torch.equal(model.state_dict()[n], start[n])
    if freeze_level >= 2:   # the whole model ran in inference mode
        for k, v in model.state_dict().items():
            if k.endswith(('running_mean', 'running_var')):
                assert torch.equal(v, start[k])
    if ema is not None:
        want = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, jstate.ema_params))
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(
                tstate.ema_params[k].numpy(), w, rtol=0,
                atol=1e-4 * max(float(np.abs(w).max()), 1e-12))


def test_gradient_accumulation_matches_optax_multisteps(weights, jmodel):
    """k = 2: no update after the first micro-step, one update with the
    averaged gradient after the second; BatchNorm statistics and the EMA
    move on every micro-step.  (One update: after it the two runs' states
    differ by the rounding-level Adam elements, see the docstring.)"""
    jstate, tstate, model, topt = _run_both(
        weights, jmodel, OPTIMIZERS['adam'], 0, 0.9, accum=2, steps=2)
    assert topt.count == 1 and topt.mini_step == 0
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    _assert_state_dict_close(
        model, params, stats, 2e-6 + 1e-3 * LR,
        noise=(_moment_trees(jstate.opt_state)[0], 2 * LR))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.ema_params))
    for k, w in want.items():
        np.testing.assert_allclose(
            tstate.ema_params[k].numpy(), w.numpy(), rtol=0,
            atol=1e-4 * max(float(w.abs().max()), 1e-12))


# ---------------------------------------------------------------------------
# learning-rate schedules and optimizer settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('sched', [
    {'type': 'cosine_annealing', 'warmup_epochs': 3},
    {'type': 'cosine_annealing', 'warmup_epochs': 0, 'min_lr': 1e-5},
    {'type': 'cosine_annealing', 'warmup_epochs': 1,
     'warmup_lr_factor': 0.1},
    {'type': 'constant'}])
@pytest.mark.parametrize('spe,epochs', [(7, 10), (1, 4), (3, 1)])
def test_lr_schedules_match_optax(sched, spe, epochs):
    config = _config({'type': 'adam'}, sched)
    want = jbuilder.make_lr_schedule(config, spe, epochs)
    got = builder.make_lr_schedule(config, spe, epochs)
    for count in range(spe * epochs + 5):
        _close(got(count), float(want(count)), 1e-6, count)


def test_schedule_drives_the_optimizer_by_update_count():
    """The learning rate of update n is schedule(n), read before the
    count advances; under accumulation the count is of updates."""
    config = _config({'type': 'sgd', 'momentum': 0.0},
                     {'type': 'cosine_annealing', 'warmup_epochs': 1})
    sched = builder.make_lr_schedule(config, 3, 2)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = builder.create_optimizer_from_config(config, [p], sched, 2)
    seen = []
    for i in range(8):
        p.grad = torch.ones(1)
        if opt.step():
            seen.append(opt.lr)
        opt.zero_grad()
    assert opt.count == 4
    np.testing.assert_allclose(seen, [sched(n) for n in range(4)])
    # plateau: fixed in place, moments kept
    opt.set_lr(1e-5)
    assert opt.lr == 1e-5 and opt.schedule is None


def test_optimizer_settings_follow_the_jax_builder():
    p = [torch.nn.Parameter(torch.zeros(2))]
    adam = builder.create_optimizer_from_config(_config({'type': 'adam'}), p)
    assert adam.inner.defaults['eps'] == 1e-7            # torch's is 1e-8
    adamw = builder.create_optimizer_from_config(
        _config({'type': 'adamw', 'decay': 3e-4}), p)
    assert isinstance(adamw.inner, torch.optim.AdamW)
    assert adamw.inner.defaults['weight_decay'] == 3e-4
    adamw = builder.create_optimizer_from_config(
        _config({'type': 'adamw'}), p)
    assert adamw.inner.defaults['weight_decay'] == 5e-4
    sgd = builder.create_optimizer_from_config(_config({'type': 'sgd'}), p)
    assert sgd.inner.defaults['momentum'] == 0.937
    assert sgd.inner.defaults['nesterov'] is False
    for kind in ('adam', 'sgd'):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            opt = builder.create_optimizer_from_config(
                _config({'type': kind, 'decay': 0.01}), p)
        assert any('decay is ignored' in str(x.message) for x in w)
        assert opt.inner.defaults.get('weight_decay', 0) == 0
    with pytest.raises(ValueError, match='unknown optimizer'):
        builder.create_optimizer_from_config(_config({'type': 'lamb'}), p)


def test_flax_like_init_and_builder_settings(tmp_path):
    """Seeded flax-like init (LeCun-normal kernels, BN identity),
    ``bn_momentum`` from the config, and ``environment.remat`` read into
    the model."""
    anchors = tmp_path / 'a.txt'
    anchors.write_text('40,40 30,50 50,30\n20,20 14,28 28,14\n'
                       '10,10 7,14 14,7\n')
    config = {'model': {'type': 'preset', 'preset': {
        'architecture': 'multigriddet_tiny', 'num_classes': NC,
        'input_shape': [*HW, 3], 'anchors_path': str(anchors),
        'bn_momentum': 0.9}}, 'training': {'loss': dict(LOSS)}}
    model, spec, loss_cfg = builder.build_model_for_training(config,
                                                             device='cpu')
    again, _, _ = builder.build_model_for_training(config, device='cpu')
    assert model.training and loss_cfg.use_consensus_loss
    sd = model.state_dict()
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    w = sd['head._ScaleHead_0.ConvBN_0.Conv_0.weight']
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert torch.equal(sd['backbone.ConvBN_0.BatchNorm_0.weight'],
                       torch.ones(16))
    assert torch.equal(sd['backbone.ConvBN_0.BatchNorm_0.running_var'],
                       torch.ones(16))
    assert model.backbone.ConvBN_0.bn_momentum == 0.9
    jcfg = jbuilder.loss_config_from_config(config)
    assert loss_cfg.__dict__ == jcfg.__dict__
    # environment.remat (item 16) is ported: the backbone is checkpointed
    for remat, mode in ((True, 'conv'), ('conv', 'conv'), ('full', 'full')):
        config['environment'] = {'remat': remat}
        model, _, _ = builder.build_model_for_training(config, device='cpu')
        assert model.remat == mode


def test_class_weights_and_counts_match_jax():
    from multigriddet_tpu.utils import anchors as janchors
    from multigriddet_tpu_torch.utils import anchors
    lines = ['a.jpg 1,2,3,4,0 5,6,7,8,2 1,1,2,2,2', 'b.jpg 0,0,5,5,1',
             'c.jpg', 'd.jpg 1,1,4,4,2 2,2,3,3,9']
    np.testing.assert_array_equal(
        anchors.class_counts_from_annotations(lines, NC),
        janchors.class_counts_from_annotations(lines, NC))
    counts = [5, 1, 40]
    for method in ('balanced', 'inverse', 'sqrt_inverse'):
        np.testing.assert_allclose(
            anchors.compute_class_weights(counts, method),
            janchors.compute_class_weights(counts, method), rtol=1e-6)
    config = {'training': {'class_weights': 'auto'}}
    np.testing.assert_allclose(
        builder.class_weights_from_config(config, NC, lines),
        jbuilder.class_weights_from_config(config, NC, lines), rtol=1e-6)


# ---------------------------------------------------------------------------
# eval step, fused step, calibration
# ---------------------------------------------------------------------------

def test_eval_step_matches_jax(weights, jmodel):
    pixels, boxes = _batch(3)
    images = pixels.astype(np.float32) / 255.0
    y_true = _targets(boxes)
    params, stats = weights
    jstate = jstate_mod.create_train_state(params, stats, optax.identity())
    want = jsteps.make_eval_step(jmodel, ANCHORS, NC, HW,
                                 JLossConfig(**LOSS))(
        jstate, jnp.asarray(images), y_true)
    model = _torch_model(weights)
    state = create_train_state(model, None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = make_eval_step(ANCHORS, NC, HW, LossConfig(**LOSS))(
        state, torch.from_numpy(images), [torch.from_numpy(y) for y in y_true])
    assert set(got) == set(want)
    for k in want:
        _close(float(got[k]), float(want[k]), 1e-5, k)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_fused_train_step_matches_jax(weights, jmodel, link):
    """u8 link-format batch -> f32 -> /255 -> 9-cell encoding -> step, with
    augmentation off, against JAX ``make_fused_train_step``."""
    params, stats = weights
    pixels, boxes = _batch(21)
    parts = (pixels,) if link == 'rgb' else rgb_to_yuv420_np(pixels)
    config = _config(OPTIMIZERS['adam'])
    opt = jbuilder.create_optimizer_from_config(config)
    jstate = jstate_mod.create_train_state(params, stats, opt)
    host_step, _ = jsteps.make_fused_train_step(
        jmodel, opt, ANCHORS, NC, JLossConfig(**LOSS),
        aug_cfg={'enabled': False}, donate=False)
    jstate, jm = host_step(jstate, tuple(jnp.asarray(p) for p in parts),
                           jnp.asarray(boxes), jax.random.PRNGKey(0))
    model = _torch_model(weights)
    topt = builder.create_optimizer_from_config(config, model.parameters())
    state = create_train_state(model, topt)
    t_host, bank_step = make_fused_train_step(
        ANCHORS, NC, LossConfig(**LOSS), aug_cfg={'enabled': False})
    gen = torch.Generator().manual_seed(0)
    state, tm = t_host(state, tuple(torch.from_numpy(p) for p in parts),
                       boxes, gen)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), 1e-5, k)
    _assert_state_dict_close(
        model, jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
        2e-6 + 1e-3 * LR, noise=(_moment_trees(jstate.opt_state)[0], 2 * LR))
    # the bank step from rows of a device bank (here the CPU) that hold the
    # same pixels in another order equals the host step
    perm = np.array([1, 0])
    banks = tuple(torch.from_numpy(np.ascontiguousarray(p[perm]))
                  for p in parts)
    bmodel = _torch_model(weights)
    bstate = create_train_state(bmodel, builder.create_optimizer_from_config(
        config, bmodel.parameters()))
    _, bm = bank_step(bstate, banks, perm, boxes,
                      torch.Generator().manual_seed(0))
    for k in tm:
        assert torch.equal(bm[k], tm[k]), k
    assert all(torch.equal(a, b) for a, b in zip(bmodel.state_dict().values(),
                                                  model.state_dict().values()))
    # augmentation settings build (the chain's parity: test_torch_augment)
    make_fused_train_step(ANCHORS, NC, aug_cfg={'mosaic_prob': 0.3})


def test_calibration_matches_jax(weights, jmodel):
    """Plain average of each batch's moments, from the same weights."""
    params, stats = weights
    batches = [_batch(30 + i)[0].astype(np.float32) / 255.0
               for i in range(3)]
    want = jcal.calibrate_batch_stats(
        jmodel, params, stats, [jnp.asarray(b) for b in batches])
    model = _torch_model(weights)
    momenta = [m.bn_momentum for m in model.modules()
               if hasattr(m, 'bn_momentum')]
    calibrate_batch_stats(model, [(torch.from_numpy(b), None)
                                  for b in batches])
    _assert_state_dict_close(model, params, jax.tree_util.tree_map(
        np.asarray, want), 0, TRAIN_LOGIT_RTOL)
    assert momenta == [m.bn_momentum for m in model.modules()
                       if hasattr(m, 'bn_momentum')]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calibrate_batch_stats(model, [])
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
