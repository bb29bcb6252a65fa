"""The port's learning validations (``multigriddet_tpu_torch/validate``)
against the JAX package's ``tools/validate_*.py``.

* **Datasets:** each set the port writes equals the tool's byte for byte
  (the annotation lines with the root substituted, and every JPEG), with
  the same Pillow.  ``validate_presets.make_dataset`` and
  ``validate_learning.make_dataset`` are taken from the tools' source with
  ``ast`` (importing the tools would set JAX's compilation cache inside
  the test worker); the flagship and anchor tools build their sets at
  module level, so those statements are run from the source with the
  root moved under ``tmp_path``, never the script.
* **Scoring:** the port's scoring loop against the tools' loop written
  with the JAX package (Pillow's letterbox, ``make_infer_step``,
  ``calculate_map``), from the same flax variables carried over with
  ``models/weights.py``: ``multigriddet_tiny`` at 64x64 on the 16 images
  of the learning set, for the three batchings of the tools (chunks with
  an unpadded last one, chunks padded by repeating the last image, one
  image at a time).  Keep sets, order and classes exact; boxes and scores
  within 1e-4; mAP50 and mAP within 1e-6.
* **Training:** four epochs of the runner's loop (the fewest the tools'
  3-epoch warmup allows) against the JAX
  ``make_train_step`` under ``optax.adam(optax.warmup_cosine_decay_
  schedule(...))`` on the JAX generator, augmentation off, from the same
  weights: each step's loss within 1e-3 relative (the trainer tests'
  bound: after the first update Adam moves rounding-level gradient
  elements by the learning rate in directions the rounding picks), and
  the learning rate of every update within 1e-9 of optax's float32
  schedule (1e-6 of the 1e-3 peak; float32 rounds the peak by ~5e-11).  The runner's schedule at the tools' own settings
  (3 warmup epochs) equals optax's too.
* **CLI:** every mode parses, with the tools' subsets and flags; the
  tools' pass lines (overfit mAP50 > 0.95, presets every mAP50 > 0.7)
  decide the exit code; a one-epoch CPU run writes its report; without a
  card the CLI raises.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from multigriddet_tpu_torch.models import (create_model, load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.validate import datasets, runner
from multigriddet_tpu_torch.validate import __main__ as cli
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, 'tools')
HW = (64, 64)
# optax computes the schedule in float32: its rate at count 0 lies 7.6e-11
# from 1e-5 (the peak's float32 rounding); 1e-6 of the 1e-3 peak
LR_ATOL = 1e-9
# the learning set at 64x64: one anchor a level, sized for the canvas
TINY = runner.Task(
    name='tiny', model='multigriddet_tiny', dataset='boxes',
    anchors=(np.array([[24, 24]], np.float32),
             np.array([[12, 12]], np.float32),
             np.array([[6, 6]], np.float32)),
    num_classes=2, epochs=runner.MIN_SCHEDULED_EPOCHS,
    loss={'loss_option': 2, 'coord_scale': 5.0, 'no_object_scale': 0.5,
          'label_smoothing': 0.01},
    hw=HW, batch_size=8, max_boxes=4, augment={'enabled': False},
    dtype=torch.float32, bn_momentum=None, shuffle_lines=False,
    log_every=1, confidence=0.25, score_max_boxes=12, pre_nms_top_k=128,
    score_batch=6)


def _tool_namespace():
    from PIL import Image, ImageDraw
    return {'np': np, 'os': os, 'Image': Image, 'ImageDraw': ImageDraw}


def _tool_function(tool, name, globals_=()):
    """``name`` from ``tools/<tool>.py``, with the module-level assignments
    it reads, compiled from the source alone."""
    tree = ast.parse(open(os.path.join(TOOLS, f'{tool}.py')).read())
    body = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == name)
            or (isinstance(n, ast.Assign) and any(
                getattr(t, 'id', None) in globals_ for t in n.targets))]
    ns = _tool_namespace()
    exec(compile(ast.Module(body=body, type_ignores=[]), tool, 'exec'), ns)
    return ns[name]


def _tool_module_level_set(tool, root):
    """Run the module-level statements of ``tools/<tool>.py`` that write
    its set, from the one after ``root = ...`` to the write of
    ``ann.txt``, with ``root`` set to ``root``."""
    tree = ast.parse(open(os.path.join(TOOLS, f'{tool}.py')).read())
    first = next(i for i, n in enumerate(tree.body)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], 'id', None) == 'root')
    last = next(i for i, n in enumerate(tree.body)
                if isinstance(n, ast.Expr) and 'ann.txt' in ast.unparse(n))
    ns = _tool_namespace()
    ns['root'] = str(root)
    exec(compile(ast.Module(body=tree.body[first + 1:last + 1],
                            type_ignores=[]), tool, 'exec'), ns)
    return os.path.join(str(root), 'ann.txt')


def _tool_set(which, root):
    if which == 'presets':
        return _tool_function('validate_presets', 'make_dataset',
                              ('SHAPES', 'COLORS'))(str(root))
    if which == 'learning':
        os.makedirs(root)
        return _tool_function('validate_learning', 'make_dataset')(str(root))
    return _tool_module_level_set(
        {'flagship': 'validate_flagship',
         'anchors': 'validate_anchor_prediction'}[which], root)


@pytest.mark.parametrize('which,port_set', [
    ('presets', 'shapes'), ('flagship', 'shapes'), ('learning', 'boxes'),
    ('anchors', 'anchor_bands')])
def test_datasets_equal_the_tools_byte_for_byte(which, port_set, tmp_path):
    tool_root, port_root = tmp_path / 'tool', tmp_path / 'port'
    tool_ann = _tool_set(which, tool_root)
    port_ann = datasets.SETS[port_set](str(port_root))
    want = open(tool_ann).read().replace(str(tool_root), str(port_root))
    assert open(port_ann).read() == want
    names = sorted(os.listdir(tool_root))
    assert names == sorted(os.listdir(port_root))
    assert len(names) > 16 or which == 'learning'
    for name in (n for n in names if n != 'ann.txt'):
        assert (open(tool_root / name, 'rb').read()
                == open(port_root / name, 'rb').read()), name


@pytest.fixture(scope='module')
def learning_set(tmp_path_factory):
    root = tmp_path_factory.mktemp('learning')
    ann = datasets.boxes(str(root))
    from multigriddet_tpu_torch.data import load_annotation_lines
    return load_annotation_lines(ann, shuffle=False)


@pytest.fixture(scope='module')
def variables():
    model = create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                         num_classes=2)
    return random_flax_variables(model, seed=3)


def _jax_tool_scoring(task, lines, variables):
    """The tools' scoring loop, in the JAX package."""
    import jax.numpy as jnp
    from PIL import Image
    from multigriddet_tpu.data.annotations import (letterbox_image,
                                                   parse_annotation_line)
    from multigriddet_tpu.evaluation import calculate_map
    from multigriddet_tpu.models import create_model as jax_create_model
    from multigriddet_tpu.training import make_infer_step
    model = jax_create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                             num_classes=2)
    infer = make_infer_step(model, list(task.anchors), task.hw,
                            confidence=task.confidence,
                            max_boxes=task.score_max_boxes,
                            pre_nms_top_k=task.pre_nms_top_k)
    trained = {'params': variables[0], 'batch_stats': variables[1]}
    preds, gts = {}, {}
    bs = task.score_batch
    for start in range(0, len(lines), bs):
        arrs, metas = [], []
        for line in lines[start:start + bs]:
            path, b = parse_annotation_line(line)
            arr, _, _, _ = letterbox_image(Image.open(path).convert('RGB'),
                                           task.hw)
            arrs.append(arr)
            metas.append(b)
        if task.pad_last:
            arrs += [arrs[-1]] * (bs - len(arrs))
        bx, cl, sc, valid = map(np.asarray, infer(
            trained, jnp.asarray(np.stack(arrs))))
        for j, b in enumerate(metas):
            k = valid[j]
            preds[start + j] = {'boxes': bx[j][k],
                                'classes': cl[j][k].astype(np.int32),
                                'scores': sc[j][k]}
            gts[start + j] = {
                'boxes': np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0],
                                   b[:, 3] - b[:, 1]], -1),
                'classes': b[:, 4].astype(np.int32)}
    kw = ({} if task.iou_thresholds is None
          else {'iou_thresholds': list(task.iou_thresholds)})
    return calculate_map(preds, gts, task.num_classes, **kw), preds


@pytest.mark.parametrize('batching', [
    dict(score_batch=6),                                  # flagship, presets
    dict(score_batch=6, pad_last=True),                   # anchors
    dict(score_batch=1, iou_thresholds=(0.5,))],          # learning
    ids=['chunks', 'padded', 'one_at_a_time'])
def test_scoring_equals_the_tools_loop(learning_set, variables, batching):
    task = dataclasses.replace(TINY, **batching)
    want, want_preds = _jax_tool_scoring(task, learning_set, variables)
    model = create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                         num_classes=2)
    load_flax_variables(model, *variables)
    got, chunks = runner.score(model, task, learning_set, 'cpu', 'xla')
    assert len(chunks) == -(-len(learning_set) // task.score_batch)
    assert all(len(c[0]) == (task.score_batch if task.pad_last
                             else min(task.score_batch,
                                      len(learning_set) - i * task.score_batch))
               for i, c in enumerate(chunks))
    n = 0
    for i, w in want_preds.items():
        g = _preds_of(chunks, task, i)
        np.testing.assert_array_equal(g['classes'], w['classes'])
        np.testing.assert_allclose(g['boxes'], w['boxes'], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(g['scores'], w['scores'], rtol=0,
                                   atol=1e-4)
        n += len(w['classes'])
    assert n > len(learning_set)       # the weights keep boxes to compare
    for key in ('mAP50', 'mAP'):
        assert abs(float(got[key]) - float(want[key])) <= 1e-6, key


def _preds_of(chunks, task, i):
    bx, cl, sc, valid = chunks[i // task.score_batch]
    j = i % task.score_batch
    k = valid[j]
    return {'boxes': bx[j][k], 'classes': cl[j][k], 'scores': sc[j][k]}


def test_training_matches_jax_make_train_step(learning_set, variables):
    import jax
    import optax
    from multigriddet_tpu.data import MultiGridDataGenerator as JaxGenerator
    from multigriddet_tpu.losses import LossConfig as JLossConfig
    from multigriddet_tpu.models import create_model as jax_create_model
    from multigriddet_tpu.training import (create_train_state,
                                           make_train_step)
    task = TINY
    spe = len(learning_set) // task.batch_size
    sched = optax.warmup_cosine_decay_schedule(1e-5, 1e-3, 3 * spe,
                                               task.epochs * spe, 1e-6)
    tx = optax.adam(sched)
    jmodel = jax_create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                              num_classes=2)
    params, stats = jax.tree_util.tree_map(np.asarray, variables)
    state = create_train_state(params, stats, tx)
    step = make_train_step(jmodel, tx, list(task.anchors),
                           task.num_classes, task.hw,
                           JLossConfig(**task.loss), donate=False)
    gen = JaxGenerator(learning_set, list(task.anchors), task.num_classes,
                       task.hw, batch_size=task.batch_size,
                       max_boxes=task.max_boxes, augment={'enabled': False},
                       train=True, seed=0)
    want = []
    for _ in range(task.epochs):
        for images, y_true, _ in gen:
            state, m = step(state, images, y_true)
            want.append(float(m['loss']))
    gen.close()
    got = runner.train(task, learning_set, 'cpu', variables=variables,
                       log=lambda msg: None)
    assert len(got.losses) == len(want) == task.epochs * spe
    for i, (g, w) in enumerate(zip(got.losses, want)):
        assert abs(g - w) <= 1e-3 * abs(w), (i, g, w)
    assert want[-1] < want[0]
    for i, lr in enumerate(got.lrs):
        assert abs(lr - float(sched(i))) <= LR_ATOL, (i, lr)
    assert got.images == len(want) * task.batch_size
    assert len(got.epoch_losses) == task.epochs


@pytest.mark.parametrize('epochs,spe', [(120, 12), (60, 12), (4, 3)])
def test_schedule_at_the_tools_settings_is_optax(epochs, spe):
    import optax
    task = dataclasses.replace(runner.FLAGSHIP, epochs=epochs)
    got = runner.learning_rate(task, spe)
    want = optax.warmup_cosine_decay_schedule(1e-5, 1e-3, 3 * spe,
                                              epochs * spe, 1e-6)
    for count in sorted({0, 1, 3 * spe - 1, 3 * spe, 3 * spe + 1,
                         epochs * spe // 2, epochs * spe - 1,
                         epochs * spe, epochs * spe + 5}):
        assert abs(got(count) - float(want(count))) <= LR_ATOL, count
    assert runner.learning_rate(runner.LEARNING, 2) == 2e-3


@pytest.mark.parametrize('argv,mode,names,ema', [
    (['learning'], 'learning', ['learning'], False),
    (['flagship', '--ema'], 'flagship', ['flagship'], True),
    (['presets'], 'presets', ['csp', 'panet', 'resnet', 'mobile'], False),
    (['presets', 'mobile', 'multi_anchor', '--epochs', '4'], 'presets',
     ['mobile', 'multi_anchor'], False),
    (['anchors', '--nms-backend', 'pallas_fused', '--device', 'cpu'],
     'anchors', ['anchors'], False)])
def test_cli_parses_every_mode(argv, mode, names, ema):
    args = cli.parse_args(argv)
    assert (args.mode, args.ema) == (mode, ema)
    tasks = cli.tasks(args.mode, args.presets, args.epochs)
    assert [t.name for t in tasks] == names
    for t in tasks:
        assert t.epochs == (args.epochs or {
            'learning': 600, 'flagship': 120, 'anchors': 120}.get(mode, 60))
        assert t.multi_anchor == (t.name == 'multi_anchor')
    assert args.device == ('cpu' if '--device' in argv else 'cuda')
    assert args.nms_backend == ('pallas_fused' if '--nms-backend' in argv
                                else 'xla')


@pytest.mark.parametrize('argv', [['learning', 'csp'], ['presets', 'yolo'],
                                  ['anchors', '--ema'], ['overfit'],
                                  ['flagship', '--epochs', '3']])
def test_cli_refuses_what_the_tools_do_not_take(argv):
    with pytest.raises(SystemExit):
        cli.parse_args(argv)


def test_tasks_carry_the_tools_settings():
    """Spot checks against the tools' constants."""
    assert runner.PRESETS['multi_anchor'].model == 'multigriddet_csp_darknet'
    assert runner.ANCHORS.num_anchors == (3, 3, 3)
    np.testing.assert_allclose(runner.ANCHORS.anchors[0],
                               [[68.16, 135.36], [96, 96], [135.36, 68.16]],
                               rtol=1e-6)
    assert (runner.ANCHORS.pad_last, runner.ANCHORS.cache_images,
            runner.ANCHORS.score_max_boxes) == (True, True, 8)
    assert (runner.FLAGSHIP.score_batch, runner.FLAGSHIP.pad_last,
            runner.FLAGSHIP.dtype) == (16, False, torch.bfloat16)
    assert (runner.LEARNING.score_batch, runner.LEARNING.confidence,
            runner.LEARNING.pre_nms_top_k) == (1, 0.15, 64)


@pytest.mark.parametrize('mode,maps,verdict', [
    ('learning', [0.96], True), ('learning', [0.95], False),
    ('presets', [0.71, 0.9], True), ('presets', [0.9, 0.7], False),
    ('flagship', [0.1], None), ('anchors', [0.1], None)])
def test_pass_lines_are_the_tools(mode, maps, verdict):
    names = {'learning': ['learning'], 'presets': ['csp', 'mobile'],
             'flagship': ['flagship'], 'anchors': ['anchors']}[mode]
    results = [{'task': n, 'mAP50': m} for n, m in zip(names, maps)]
    assert cli.passes(mode, results) is verdict


def test_cli_runs_on_the_cpu_and_needs_a_card_otherwise(tmp_path, capsys):
    report = tmp_path / 'report.json'
    rc = cli.main(['learning', '--epochs', '1', '--device', 'cpu',
                   '--root', str(tmp_path / 'set'), '--report', str(report)])
    out = capsys.readouterr().out
    assert rc == 1 and 'learning validation FAILED' in out
    res = json.loads(report.read_text())['results'][0]
    assert (res['task'], res['epochs'], res['steps']) == ('learning', 1, 2)
    assert np.isfinite(res['final_loss']) and 'xla' in res['scores']
    assert 'final loss' in out and 'img/s' in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cli.main(['learning', '--epochs', '1',
                      '--root', str(tmp_path / 'set2')])
