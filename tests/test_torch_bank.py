"""The port's device image bank and the generator's and trainer's bank path,
on the CPU (the bank lives on the generator's device; here that is the CPU).

* A batch gathered from the bank equals the host path's u8 parts bit for
  bit, rgb and yuv420, and epoch 2 loads nothing from the host.
* Over budget, a canvas warns and streams; one ledger shared by two
  caches counts both banks; an insert that cannot place every row rolls
  back, so ``has()`` stays false for its lines.
* ``MultiGridTrainer`` with the shipped augmentation block and
  ``cache_images_device: true`` takes epoch 2 from the bank, and each
  bank step equals the host-path step (from a copy of the same state) for
  the same batch, loaded from the files, and the same generator: equal
  metrics and equal weights after it.
"""

import copy
import math

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from multigriddet_tpu_torch.data import MultiGridDataGenerator
from multigriddet_tpu_torch.data.pipeline import (_device_stage,
                                                  _device_stage_bank,
                                                  _DeviceImageCache)
from multigriddet_tpu_torch.models import create_model, random_flax_variables
from multigriddet_tpu_torch.training import MultiGridTrainer, save_params
from multigriddet_tpu_torch.training import trainer as trainer_mod

ANCHORS = [np.array([[40, 40]], np.float32), np.array([[20, 20]], np.float32),
           np.array([[10, 10]], np.float32)]
HW = (64, 64)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('bank')
    rng = np.random.RandomState(4)
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
    model = create_model('multigriddet_tiny', num_anchors=(1, 1, 1),
                         num_classes=2)
    params, stats = random_flax_variables(model, seed=3)
    save_params(str(root / 'init.msgpack'),
                {'params': params, 'batch_stats': stats})
    return root, lines


def _gen(lines, **kw):
    args = dict(anchors=ANCHORS, num_classes=2, input_shape=HW, batch_size=4,
                max_boxes=5, augment={'enabled': False}, num_workers=2,
                cache_images_device=True, device='cpu')
    args.update(kw)
    return MultiGridDataGenerator(lines, **args)


@pytest.mark.parametrize('link', ['rgb', 'yuv420'])
def test_bank_gather_equals_the_host_path(dataset, link, monkeypatch):
    _, lines = dataset
    gen = _gen(lines, link_format=link)
    first = list(gen.iter_raw())
    assert [item[0] for item in first] == ['host', 'host']
    assert gen._dcache.bytes == len(lines) * (
        HW[0] * HW[1] * 3 // (2 if link == 'yuv420' else 1))

    def no_host_load(batch_lines, hw):
        raise AssertionError('epoch 2 loaded from the host')
    want_loader = gen.loader.load_batch
    monkeypatch.setattr(gen.loader, 'load_batch', no_host_load)
    second = list(gen.iter_raw())
    assert [item[0] for item in second] == ['bank', 'bank']
    inverse = {row: line for (line, _), row in gen._dcache._row.items()}
    for _, banks, idx, boxes, hw, g in second:
        assert len(banks) == (3 if link == 'yuv420' else 1)
        assert isinstance(g, torch.Generator) and hw == HW
        pixels, want_boxes = want_loader([inverse[i] for i in idx], hw)
        pixels = pixels if isinstance(pixels, tuple) else (pixels,)
        for bank, part in zip(banks, pixels):
            assert bank.dtype == torch.uint8
            assert torch.equal(bank[torch.from_numpy(idx)],
                               torch.from_numpy(part))
        np.testing.assert_array_equal(boxes, want_boxes)
    # the processed path gathers the same pixels: equal to the host stage
    parts = tuple(torch.from_numpy(p) for p in pixels)
    host = _device_stage(parts, want_boxes, None, {'enabled': False},
                         ANCHORS, 2, HW, True)
    bank = _device_stage_bank(banks, idx, boxes, None, {'enabled': False},
                              ANCHORS, 2, HW, True)
    assert torch.equal(host[0], bank[0])
    assert all(torch.equal(a, b) for a, b in zip(host[1], bank[1]))
    gen.close()


def test_processed_epoch_two_from_the_bank_equals_epoch_one(dataset):
    """``__iter__`` over a non-shuffling generator: epoch 2 (bank) yields
    the images, targets and boxes of epoch 1 (host)."""
    _, lines = dataset
    gen = _gen(lines, train=False)
    one = list(gen)
    assert gen._dcache.has(HW, lines)
    two = list(gen)
    for (i1, y1, b1), (i2, y2, b2) in zip(one, two):
        assert torch.equal(i1, i2) and torch.equal(b1, b2)
        assert all(torch.equal(a, b) for a, b in zip(y1, y2))
    gen.close()


def test_over_budget_warns_and_streams(dataset):
    _, lines = dataset
    gen = _gen(lines, link_format='rgb', device_cache_budget=1000)
    with pytest.warns(UserWarning, match='streams from the host'):
        first = list(gen.iter_raw())
    assert gen._dcache.bytes == 0
    assert [item[0] for item in first + list(gen.iter_raw())] == ['host'] * 4
    gen.close()


def test_one_ledger_counts_both_caches(dataset):
    _, lines = dataset
    ledger = {'bytes': 0}
    per_bank = len(lines) * HW[0] * HW[1] * 3
    train = _gen(lines, link_format='rgb', device_cache_ledger=ledger,
                 device_cache_budget=per_bank + per_bank // 2)
    val = _gen(lines, train=False, device_cache_ledger=ledger,
               device_cache_budget=per_bank + per_bank // 2)
    list(train.iter_raw())
    assert ledger['bytes'] == per_bank == train._dcache.bytes
    with pytest.warns(UserWarning, match='streams from the host'):
        list(val)
    assert ledger['bytes'] == val._dcache.bytes == per_bank
    assert not val._dcache.has(HW, lines[:4])
    # with room for both, both banks count
    ledger2 = {'bytes': 0}
    for train_flag in (True, False):
        g = _gen(lines, train=train_flag, link_format='rgb',
                 device_cache_ledger=ledger2,
                 device_cache_budget=2 * per_bank)
        list(g.iter_raw())
        g.close()
    assert ledger2['bytes'] == 2 * per_bank
    train.close()
    val.close()


def test_failed_insert_rolls_back():
    cache = _DeviceImageCache(n_rows=3, budget_bytes=1 << 20)
    part = torch.arange(2 * 4 * 4 * 3, dtype=torch.uint8).reshape(2, 4, 4, 3)
    boxes = np.ones((2, 5, 5), np.float32)
    cache.add_batch((4, 4), ['a', 'b'], (part,), boxes)
    assert cache.has((4, 4), ['a', 'b'])
    cache.add_batch((4, 4), ['c', 'd'], (part,), boxes)    # row 3 missing
    assert not cache.has((4, 4), ['c'])
    assert not cache.has((4, 4), ['a'])                     # canvas dropped
    assert ('c', (4, 4)) not in cache._row and ('c', (4, 4)) not in \
        cache._boxes


def test_trainer_epoch_two_from_the_bank_equals_the_host_step(
        dataset, tmp_path, monkeypatch):
    root, _ = dataset
    cfg = {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [*HW, 3],
            'anchors_path': str(root / 'anchors.txt'),
            'classes_path': str(root / 'classes.txt')}},
        'data': {'train_annotation': str(root / 'train.txt'),
                 'val_annotation': str(root / 'train.txt')},
        'data_loader': {'num_workers': 2, 'cache_images_device': True},
        'training': {
            'batch_size': 4, 'epochs': 2, 'learning_rate': 1e-3,
            'loss_option': 2,
            # configs/train_config.yaml's augmentation block
            'augmentation': {'enabled': True, 'enhance_type': 'mosaic',
                             'mosaic_prob': 0.3, 'mixup_prob': 0.1,
                             'rescale_interval': -1,
                             'max_boxes_per_image': 10}},
        'optimizer': {'type': 'adam'},
        'lr_schedule': {'type': 'constant'},
        'callbacks': {'checkpoint': {'save_dir': str(tmp_path / 'ckpt')}},
        'resume': {'weights_path': str(root / 'init.msgpack')},
        'output': {'log_dir': str(tmp_path / 'logs'),
                   'model_dir': str(tmp_path / 'models')},
    }
    trainer = MultiGridTrainer(cfg, device='cpu')
    made = trainer_mod.make_fused_train_step
    calls = []

    def spying_steps(*args, **kwargs):
        host_step, bank_step = made(*args, **kwargs)

        def bank_spy(state, banks, idx, boxes, gen):
            cache = trainer.train_gen._dcache
            inverse = {row: line for (line, _), row in cache._row.items()}
            pixels, host_boxes = trainer.train_gen.loader.load_batch(
                [inverse[i] for i in idx], HW)
            np.testing.assert_array_equal(host_boxes, boxes)
            ref = copy.deepcopy(state)
            ref_gen = torch.Generator()
            ref_gen.set_state(gen.get_state())
            _, want = host_step(ref, tuple(torch.from_numpy(p)
                                           for p in pixels), host_boxes,
                                ref_gen)
            state, got = bank_step(state, banks, idx, boxes, gen)
            for k in want:
                assert torch.equal(got[k], want[k]), k
            assert all(torch.equal(a, b) for a, b in zip(
                state.model.state_dict().values(),
                ref.model.state_dict().values()))
            calls.append(len(idx))
            return state, got
        return host_step, bank_spy

    monkeypatch.setattr(trainer_mod, 'make_fused_train_step', spying_steps)
    history = trainer.train()
    assert len(history) == 2 and calls == [4, 4]
    assert all(math.isfinite(r['loss']) for r in history)
    # train and validation banks share the ledger
    ledger = trainer.train_gen._dcache._ledger
    assert ledger is trainer.val_gen._dcache._ledger
    rgb_rows = 8 * HW[0] * HW[1] * 3
    assert ledger['bytes'] == trainer.train_gen._dcache.bytes == (
        rgb_rows // 2 + rgb_rows)           # yuv420 train + rgb validation
