"""The port's ``MultiGridTrainer`` and train CLI on a synthetic JPEG dataset.

Eight PIL-written JPEGs (one red or green box each, as in
``tests/test_trainer_e2e.py``), ``multigriddet_tiny`` at 64x64 with one
anchor a layer, augmentation off, on the CPU.  Every run starts from one
seeded weights bundle (``resume.weights_path``), so runs are comparable.

Checked: history, checkpoints, the frozen first stage, EMA export and BN
recalibration, resume (inside a stage, across the freeze boundary, and
after the last epoch), reduce-on-plateau and early stopping, the export
read by the JAX package's ``load_weights_flexible`` and served by the
port's engine, the unported options raising before any step (spatial
partitioning; data parallel trains since it was ported), and the CLI.

Against the JAX ``MultiGridTrainer`` on the same data and weights: each
epoch's train and validation loss within 1e-3 relative (the batch holds the
whole dataset, so both trainers see the same images whatever their
shuffles; after the first update Adam moves rounding-level gradient
elements by the learning rate in directions the rounding picks, which
moves the next losses by ~1e-5 relative).
"""

import json
import math

import numpy as np
import pytest
import torch
import yaml
from PIL import Image, ImageDraw

from multigriddet_tpu_torch.inference import MultiGridInference
from multigriddet_tpu_torch.models import (create_model, flax_to_state_dict,
                                           random_flax_variables)
from multigriddet_tpu_torch.training import (CheckpointManager,
                                             MultiGridTrainer, load_params,
                                             save_params)
from test_torch_native_oracle import jax_native_oracle  # noqa: F401

HW = (64, 64)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('ds')
    rng = np.random.RandomState(0)
    lines = []
    for i in range(8):
        img = Image.fromarray(rng.randint(0, 255, (80, 96, 3)).astype('uint8'))
        d = ImageDraw.Draw(img)
        x1, y1 = rng.randint(5, 30), rng.randint(5, 25)
        x2, y2 = x1 + rng.randint(25, 50), y1 + rng.randint(25, 45)
        cls = i % 2
        d.rectangle([x1, y1, x2, y2],
                    fill=(250, 20, 20) if cls == 0 else (20, 250, 20))
        p = root / f'img_{i}.jpg'
        img.save(p)
        lines.append(f'{p} {x1},{y1},{x2},{y2},{cls}')
    (root / 'train.txt').write_text('\n'.join(lines) + '\n')
    (root / 'classes.txt').write_text('red\ngreen\n')
    (root / 'anchors.txt').write_text('40,40\n20,20\n10,10\n')
    model = create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=7)
    save_params(str(root / 'init.msgpack'),
                {'params': params, 'batch_stats': stats})
    return root


def _config(root, out, **training):
    cfg = {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [*HW, 3],
            'anchors_path': str(root / 'anchors.txt'),
            'classes_path': str(root / 'classes.txt')}},
        'data': {'train_annotation': str(root / 'train.txt'),
                 'val_annotation': str(root / 'train.txt')},
        'data_loader': {'num_workers': 2},
        'training': {
            'batch_size': 4, 'epochs': 3, 'transfer_epochs': 1,
            'freeze_level': 1, 'learning_rate': 1e-3, 'loss_option': 2,
            'augmentation': {'enabled': False, 'max_boxes_per_image': 10},
            'loss': {'use_consensus_loss': True}},
        'optimizer': {'type': 'adam'},
        'lr_schedule': {'type': 'cosine_annealing', 'warmup_epochs': 1},
        'callbacks': {'checkpoint': {'save_dir': str(out / 'ckpt')}},
        'resume': {'weights_path': str(root / 'init.msgpack')},
        'output': {'log_dir': str(out / 'logs'),
                   'model_dir': str(out / 'models')},
    }
    cfg['training'].update(training)
    return cfg


def _init_state_dict(root):
    raw = load_params(str(root / 'init.msgpack'))
    return flax_to_state_dict(raw['params'], raw['batch_stats'])


def _finite(record):
    return all(math.isfinite(v) for v in record.values()
               if isinstance(v, float))


def test_two_stage_run_history_checkpoints_ema_and_export(dataset, tmp_path):
    """One frozen epoch (backbone bit-unchanged), two unfrozen; the EMA
    export with recalibrated statistics, read by the JAX package and
    served by the port's engine."""
    import jax
    from multigriddet_tpu.models import create_model as jax_create_model
    from multigriddet_tpu.training.checkpoint import \
        load_weights_flexible as jax_load
    cfg = _config(dataset, tmp_path, ema_decay=0.8, bn_recalibrate=True,
                  bn_recalibrate_batches=2)
    history = MultiGridTrainer(cfg, device='cpu').train()
    assert [r['epoch'] for r in history] == [0, 1, 2]
    assert all(_finite(r) and r['steps'] == 2 and r['images_per_sec'] > 0
               and 'val_loss' in r for r in history)
    lines = (tmp_path / 'logs' / 'history.jsonl').read_text().splitlines()
    assert [json.loads(ln)['epoch'] for ln in lines] == [0, 1, 2]

    ckpt = CheckpointManager(str(tmp_path / 'ckpt'))
    assert ckpt.latest_step() == 2 and ckpt.best_step() == 2
    init = _init_state_dict(dataset)
    first = ckpt.restore_raw(0)['model']
    for k, v in init.items():
        if k.startswith('backbone.') and 'running' not in k:
            assert torch.equal(first[k], v), k          # frozen stage
    head = [k for k in init if 'PredictConv' in k]
    assert head and all(not torch.equal(first[k], init[k]) for k in head)
    last = ckpt.restore_raw(2)
    assert last['ema_params'] and last['step'] == 4   # stage 2's steps

    final = tmp_path / 'models' / 'final_model.msgpack'
    jm = jax_create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                          num_classes=2)
    template = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, *HW, 3)), train=False))()
    params, stats = jax_load(str(final), template['params'],
                             template['batch_stats'])
    exported = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, stats))
    for k, v in last['ema_params'].items():
        assert torch.equal(exported[k], v), k           # EMA weights
    assert any(not torch.equal(exported[k], last['model'][k])
               for k in exported if 'running' in k)     # recalibrated
    engine = MultiGridInference({
        'model': cfg['model'], 'weights_path': str(final),
        'detection': {'confidence_threshold': 0.0}}, device='cpu')
    sd = engine.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in exported.items())
    boxes, classes, scores = engine.detect(Image.open(dataset / 'img_0.jpg'))
    assert len(boxes) and np.isfinite(scores).all()


def test_resume_inside_a_stage_across_the_boundary_and_after_the_end(
        dataset, tmp_path, capsys):
    cfg = _config(dataset, tmp_path, epochs=1)          # stage 1 only
    MultiGridTrainer(cfg, device='cpu').train()
    ckpt = CheckpointManager(str(tmp_path / 'ckpt'))
    assert ckpt.latest_step() == 0

    # the frozen-stage checkpoint restores onto stage 2's fresh optimizer
    cfg = _config(dataset, tmp_path, epochs=2)
    cfg['resume']['enabled'] = True
    capsys.readouterr()
    history = MultiGridTrainer(cfg, device='cpu').train()
    out = capsys.readouterr().out
    assert [r['epoch'] for r in history] == [1]
    assert 'freeze boundary' in out and 'fresh optimizer' in out
    one = CheckpointManager(str(tmp_path / 'ckpt')).restore_raw(1)
    assert one['step'] == 4 and one['optimizer']['count'] == 2

    # inside stage 2: the optimizer's moments and count come back
    cfg = _config(dataset, tmp_path, epochs=3)
    cfg['resume']['enabled'] = True
    capsys.readouterr()
    history = MultiGridTrainer(cfg, device='cpu').train()
    assert [r['epoch'] for r in history] == [2]
    assert 'freeze boundary' not in capsys.readouterr().out
    two = CheckpointManager(str(tmp_path / 'ckpt')).restore_raw(2)
    assert two['step'] == 6 and two['optimizer']['count'] == 4

    # every epoch trained: the export is the last checkpoint's model
    trainer = MultiGridTrainer(cfg, device='cpu')
    assert trainer.train() == []
    raw = load_params(str(tmp_path / 'models' / 'final_model.msgpack'))
    exported = flax_to_state_dict(raw['params'], raw['batch_stats'])
    assert all(torch.equal(exported[k], two['model'][k]) for k in exported)


def test_reduce_on_plateau_and_early_stopping(dataset, tmp_path, monkeypatch):
    """A validation loss that never improves after epoch 0: the learning
    rate halves in place after ``patience`` epochs (moments kept) and
    training stops after the early-stopping patience."""
    cfg = _config(dataset, tmp_path, epochs=6, transfer_epochs=0)
    cfg['lr_schedule'] = {'type': 'reduce_on_plateau', 'patience': 1,
                          'factor': 0.5}
    cfg['callbacks']['early_stopping'] = {'patience': 3}
    trainer = MultiGridTrainer(cfg, device='cpu')
    lrs, moments = [], []
    run_epoch = trainer._run_epoch

    def spy(state, train_step, epoch):
        lrs.append(state.optimizer.lr)
        moments.append(len(state.optimizer.inner.state))
        return run_epoch(state, train_step, epoch)
    monkeypatch.setattr(trainer, '_run_epoch', spy)
    monkeypatch.setattr(trainer, '_run_validation',
                        lambda state, eval_step: {'val_loss': 1.0})
    history = trainer.train()
    assert [r['epoch'] for r in history] == [0, 1, 2, 3]
    np.testing.assert_allclose(lrs, [1e-3, 1e-3, 5e-4, 2.5e-4])
    assert moments[0] == 0 and all(m > 0 for m in moments[1:])


@pytest.mark.parametrize('change,item', [
    # ported since (augmentation and the device bank): these train
    pytest.param({'training': {'augmentation': {'enabled': True}}}, None,
                 id='change0-item 10'),
    pytest.param({'training': {'augmentation': {'mosaic_prob': 0.3}}}, None,
                 id='change1-item 10'),
    pytest.param({'data_loader': {'cache_images_device': True}}, None,
                 id='change2-item 10'),
    # ported since (activation checkpointing): this trains
    pytest.param({'environment': {'remat': True}}, None,
                 id='change3-item 16'),
    # ported since (dp x sp spatial partitioning, item 18): one process
    # falls back to the 1-D mesh, as the JAX trainer does, and trains
    pytest.param({'environment': {'spatial_partition': 2}}, None,
                 id='change4-item 13'),
    # ported since (data parallel): a one-process group, named by
    # torchrun's variables, trains
    pytest.param({'environment': {'distributed': {
        'enabled': True, 'num_processes': 1, 'process_id': 0}}}, None,
                 id='change5-item 13')])
def test_unported_options_raise_before_any_step(dataset, tmp_path, change,
                                                item, monkeypatch):
    cfg = _config(dataset, tmp_path)
    for block, values in change.items():
        if block == 'training':
            cfg['training']['augmentation'] = values['augmentation']
        else:
            cfg[block] = dict(cfg.get(block, {}), **values)
    if item is None:
        cfg['training'].update(epochs=1, transfer_epochs=0)
        if 'distributed' in cfg.get('environment', {}):
            import socket
            with socket.socket() as s:
                s.bind(('localhost', 0))
                port = s.getsockname()[1]
            monkeypatch.setenv('MASTER_ADDR', 'localhost')
            monkeypatch.setenv('MASTER_PORT', str(port))
        try:
            history = MultiGridTrainer(cfg, device='cpu').train()
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        assert len(history) == 1 and math.isfinite(history[0]['loss'])
        return
    with pytest.raises(NotImplementedError, match=item):
        MultiGridTrainer(cfg, device='cpu').train()
    assert not (tmp_path / 'logs' / 'history.jsonl').exists()
    assert not (tmp_path / 'ckpt').exists() or not any(
        (tmp_path / 'ckpt').glob('checkpoint_*'))


def test_train_cli_on_cpu_and_needs_a_gpu(dataset, tmp_path, monkeypatch):
    from multigriddet_tpu_torch.train import main
    path = tmp_path / 'train.yaml'
    path.write_text(yaml.safe_dump(_config(dataset, tmp_path)))
    assert main(['--config', str(path), '--device', 'cpu', '--epochs', '2',
                 '--batch-size', '8', '--learning-rate', '5e-4']) == 0
    records = [json.loads(ln) for ln in
               (tmp_path / 'logs' / 'history.jsonl').read_text().splitlines()]
    assert [r['epoch'] for r in records] == [0, 1]
    assert all(r['steps'] == 1 for r in records)
    assert (tmp_path / 'models' / 'final_model.msgpack').exists()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(['--config', str(path)])


def test_train_cli_runs_the_shipped_config(dataset, tmp_path, monkeypatch):
    """``python -m multigriddet_tpu_torch.train`` on
    ``configs/train_config.yaml`` byte for byte (its augmentation block on:
    mosaic 0.3, mixup 0.1), with its model YAML beside it and the eight
    images as its train annotation, on the CPU at a 64x64 canvas for one
    epoch of two batches."""
    import os
    import shutil
    from multigriddet_tpu_torch.train import main
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    conf = tmp_path / 'configs'
    (conf / 'models').mkdir(parents=True)
    (conf / 'data').mkdir()
    shutil.copyfile(os.path.join(repo, 'configs', 'train_config.yaml'),
                    conf / 'train_config.yaml')
    shutil.copyfile(os.path.join(repo, 'configs', 'models',
                                 'multigriddet_darknet.yaml'),
                    conf / 'models' / 'multigriddet_darknet.yaml')
    shutil.copyfile(dataset / 'train.txt', conf / 'data' /
                    'coco_train2017.txt')
    monkeypatch.chdir(tmp_path)
    assert main(['--config', 'configs/train_config.yaml', '--device', 'cpu',
                 '--epochs', '1', '--batch-size', '4', '--input-shape', '64',
                 '64']) == 0
    records = [json.loads(ln) for ln in (
        tmp_path / 'logs' / 'training' / 'history.jsonl').read_text()
        .splitlines()]
    assert len(records) == 1 and records[0]['steps'] == 2
    assert _finite(records[0])
    assert (tmp_path / 'trained_models' / 'final_model.msgpack').exists()


def test_epoch_losses_match_the_jax_trainer(dataset, tmp_path):
    """Both trainers from the same weights file over the same 8 images
    (one batch of 8, so the shuffles do not matter): a frozen epoch, then
    two unfrozen; train and validation losses per epoch.  The JAX trainer
    runs on a one-device mesh (the port trains on one device)."""
    from multigriddet_tpu.training import MultiGridTrainer as JaxTrainer
    cfg = _config(dataset, tmp_path / 'torch', batch_size=8)
    port = MultiGridTrainer(cfg, device='cpu').train()
    jcfg = _config(dataset, tmp_path / 'jax', batch_size=8)
    import jax
    from multigriddet_tpu.training.steps import make_mesh
    want = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1])).train()
    assert len(port) == len(want) == 3
    for got, ref in zip(port, want):
        assert set(got) == set(ref)
        for k in ('loss', 'val_loss', 'location', 'objectness',
                  'val_objectness'):
            assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]), (
                got['epoch'], k, got[k], ref[k])
