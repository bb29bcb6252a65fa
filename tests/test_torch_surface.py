"""The port's public surface and its tool CLIs against the JAX package.

* **Surface:** the JAX package's lazy top level (``_SUBPACKAGES`` and
  ``_CONVENIENCE``; it has no top-level ``__all__``) and the ``__all__``
  of every subpackage resolve in the port to the port's own objects,
  except the names left out on purpose (ROADMAP item 20):
  ``encode_targets_np`` (the JAX test oracle), ``partition_optimizer``,
  ``put_global``, ``data_parallel_sharding`` and ``replicated_sharding``
  (optax and ``jax.sharding`` types; the port has ``apply_freeze`` and
  ``shard_batch``) and ``multigrid_loss_jit`` (a jit cache).
* **get_model_info:** equal to JAX's on the two configs of
  ``tests/test_cli.py`` and on every ``configs/*.yaml``.
* **port_weights:** a small seeded ``.h5`` (the one of
  ``test_torch_porting.py``, ``multigriddet_tiny`` at 64x64) through
  ``python -m multigriddet_tpu_torch.port_weights`` and through
  ``tools/port_keras_weights.py`` (run as a subprocess): the two msgpack
  files hold the same tree, every array bit-equal (flax writes the
  top-level keys in the order the JAX porter builds them, the port's
  codec sorts them, as flax's tree maps leave the nested ones).
* **visualize:** the ``y_true`` overlays of two annotation lines,
  augmentation off, equal ``tools/visualize_y_true.py``'s pixel for pixel
  (PNG images, which both loaders read through Pillow); the
  ``augmented`` mode writes its batches with boxes inside the canvas.
* **Entry points:** every new CLI and example asks for the card by
  default and raises without one.
"""

import glob
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import multigriddet_tpu
import multigriddet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = multigriddet_tpu._SUBPACKAGES
# left out on purpose (ROADMAP item 20)
EXCLUDED = {'ops': {'encode_targets_np'},
            'training': {'partition_optimizer'},
            'parallel': {'put_global', 'data_parallel_sharding',
                         'replicated_sharding'},
            'losses': {'multigrid_loss_jit'}}


def test_top_level_is_lazy_and_has_the_jax_names():
    code = ('import sys, multigriddet_tpu_torch as m; '
            'assert "multigriddet_tpu_torch.models" not in sys.modules; '
            'm.create_model; assert "multigriddet_tpu_torch.models" in '
            'sys.modules; print(sorted(k for k in sys.modules '
            'if k.split(".")[0] in ("jax", "multigriddet_tpu")))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
    assert set(SUBPACKAGES) <= set(multigriddet_tpu_torch._SUBPACKAGES)
    assert set(multigriddet_tpu._CONVENIENCE) <= set(
        dir(multigriddet_tpu_torch))
    for name, (sub, attr) in multigriddet_tpu._CONVENIENCE.items():
        got = getattr(multigriddet_tpu_torch, name)
        want = getattr(importlib.import_module(
            f'multigriddet_tpu_torch.{sub}'), attr)
        assert got is want and got.__module__.startswith(
            'multigriddet_tpu_torch'), name
    assert multigriddet_tpu_torch.resolve_device('cpu').type == 'cpu'
    with pytest.raises(AttributeError):
        multigriddet_tpu_torch.not_a_name


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_subpackage_all_covers_the_jax_names(sub):
    jax_mod = importlib.import_module(f'multigriddet_tpu.{sub}')
    port = getattr(multigriddet_tpu_torch, sub)
    assert port.__name__ == f'multigriddet_tpu_torch.{sub}'
    excluded = EXCLUDED.get(sub, set())
    assert excluded <= set(jax_mod.__all__), excluded
    missing = [n for n in jax_mod.__all__
               if n not in excluded and n not in port.__all__]
    assert not missing, missing
    for name in port.__all__:
        value = getattr(port, name)
        module = getattr(value, '__module__', None) or getattr(
            value, '__name__', '')
        if callable(value) or isinstance(value, type(port)):
            assert module.startswith('multigriddet_tpu_torch'), name
    for name in excluded:
        assert not hasattr(port, name), name


def _cli_configs():
    return [
        {'model': {'name': 'm', 'type': 'preset', 'preset': {
            'architecture': 'multigriddet_darknet', 'num_classes': 4,
            'input_shape': [416, 416, 3]}}},
        {'model': {'type': 'custom', 'custom': {
            'backbone': {'type': 'darknet53'},
            'neck': {'type': 'multigrid_fpn'},
            'head': {'type': 'multigrid', 'num_classes': 7}}}},
        {}]


@pytest.mark.parametrize('path', sorted(
    glob.glob(os.path.join(REPO, 'configs', '*.yaml'))
    + glob.glob(os.path.join(REPO, 'configs', 'models', '*.yaml'))),
    ids=os.path.basename)
def test_get_model_info_equals_jax_on_shipped_configs(path):
    from multigriddet_tpu.config import get_model_info as jax_info
    from multigriddet_tpu_torch.config import get_model_info
    with open(path) as f:
        config = yaml.safe_load(f)
    assert get_model_info(config) == jax_info(config)
    for config in _cli_configs():
        assert get_model_info(config) == jax_info(config)


def _tiny_h5(tmp_path):
    """The seeded ``multigriddet_tiny`` ``.h5`` of ``test_torch_porting``
    and a model config that builds the same model."""
    from test_torch_porting import _keras_units, _models, _write_h5
    jm, variables, _, hw = _models('tiny')
    units = _keras_units(jm, variables, hw, np.random.RandomState(11))
    h5 = tmp_path / 'tiny.h5'
    _write_h5(str(h5), units, 'legacy')
    cfg = tmp_path / 'tiny.yaml'
    cfg.write_text(yaml.safe_dump({'model': {'type': 'preset', 'preset': {
        'architecture': 'multigriddet_tiny', 'num_classes': 3,
        'input_shape': [*hw, 3]}}}))
    return h5, cfg


def test_port_weights_equals_the_jax_tool(tmp_path, capsys):
    from multigriddet_tpu_torch import port_weights
    h5, cfg = _tiny_h5(tmp_path)
    want = tmp_path / 'jax.msgpack'
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'port_keras_weights.py'),
         '--h5', str(h5), '--model-config', str(cfg), '--out', str(want)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = tmp_path / 'port.msgpack'
    assert port_weights.main(['--h5', str(h5), '--model-config', str(cfg),
                              '--out', str(got), '--device', 'cpu']) == 0
    assert 'Ported' in capsys.readouterr().out
    from multigriddet_tpu_torch.models import msgpack_restore
    g = msgpack_restore(got.read_bytes())
    w = msgpack_restore(want.read_bytes())

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for k in tree:
                yield from leaves(tree[k], f'{prefix}/{k}')
        else:
            yield prefix, np.asarray(tree)

    g, w = dict(leaves(g)), dict(leaves(w))
    assert set(g) == set(w) and len(g) > 100
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert g[k].tobytes() == w[k].tobytes(), k


@pytest.fixture(scope='module')
def png_lines(tmp_path_factory):
    """Two PNG images with boxes of two classes, their annotation and
    class files."""
    from PIL import Image, ImageDraw
    root = tmp_path_factory.mktemp('viz')
    rng = np.random.RandomState(2)
    lines = []
    for i, (w, h) in enumerate([(96, 80), (70, 100)]):
        img = Image.fromarray(rng.randint(0, 120, (h, w, 3)).astype('uint8'))
        d = ImageDraw.Draw(img)
        toks = []
        for k in range(2):
            x1, y1 = rng.randint(0, w // 2), rng.randint(0, h // 2)
            x2, y2 = x1 + rng.randint(12, w // 2), y1 + rng.randint(12, h // 2)
            d.rectangle([x1, y1, x2, y2], fill=(220, 40 + 150 * k, 40))
            toks.append(f'{x1},{y1},{x2},{y2},{k}')
        p = root / f'img_{i}.png'
        img.save(p)
        lines.append(f'{p} ' + ' '.join(toks))
    ann = root / 'ann.txt'
    ann.write_text('\n'.join(lines) + '\n')
    classes = root / 'classes.txt'
    classes.write_text('red\nyellow\n')
    return root, ann, classes


def test_visualize_y_true_equals_the_jax_tool(png_lines, tmp_path):
    from PIL import Image
    from multigriddet_tpu_torch import visualize
    root, ann, classes = png_lines
    args = ['--annotation', str(ann), '--classes', str(classes),
            '--input-size', '64', '--num', '2']
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tools', 'visualize_y_true.py'),
         *args, '--out', str(tmp_path / 'jax')],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert visualize.main(['y_true', *args, '--out', str(tmp_path / 'port'),
                           '--device', 'cpu']) == 0
    for b in range(2):
        want = np.asarray(Image.open(tmp_path / 'jax' / f'ytrue_{b}.png'))
        got = np.asarray(Image.open(tmp_path / 'port' / f'ytrue_{b}.png'))
        assert got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)
        assert (got == 255).all(-1).any()      # the white annotation boxes


def test_visualize_augmented_writes_batches(png_lines, tmp_path, capsys):
    from multigriddet_tpu_torch import visualize
    root, ann, classes = png_lines
    args = visualize.parse_args(
        ['augmented', '--annotation', str(ann), '--classes', str(classes),
         '--input-size', '64', '--batch-size', '2', '--batches', '1',
         '--out', str(tmp_path), '--device', 'cpu'])
    assert (args.mosaic, args.mixup, args.batches) == (0.5, 0.25, 1)
    out = visualize.augmented_overlays(args)
    assert len(out) == 2
    for path, img, n in out:
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
        assert os.path.basename(path).startswith('batch0_img')
    assert visualize.main(['augmented', '--annotation', str(ann),
                           '--classes', str(classes), '--input-size', '64',
                           '--batch-size', '2', '--batches', '1',
                           '--out', str(tmp_path), '--device', 'cpu']) == 0
    assert capsys.readouterr().out.count('wrote') == 2


@pytest.mark.parametrize('module,argv', [
    ('examples.inference_example', []),
    ('examples.serving_example', []),
    ('examples.training_example', []),
    ('examples.camera_example', []),
    ('visualize', ['y_true', '--annotation', 'a.txt', '--classes',
                   'configs/coco_classes.txt']),
    ('port_weights', ['--h5', 'x.h5', '--out', 'x.msgpack'])])
def test_entry_points_need_a_card_by_default(module, argv, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    monkeypatch.chdir(REPO)
    mod = importlib.import_module(f'multigriddet_tpu_torch.{module}')
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main(argv)
