"""The training loop: ``MultiGridDataGenerator`` with the device bank
feeding the fused bank train step that ``MultiGridTrainer`` builds.

Set-up writes the traffic's JPEG files (seeded photo-like frames with
their boxes) into a temporary directory, builds the trainer from the
traffic's ``training``, ``optimizer`` and ``lr_schedule`` blocks, hands
the model the benchmark's weights, and runs epoch 1 through the
generator without training, which decodes every file on the card and
fills the bank.  The first steps from the bank (``check_steps``) are the
ones the check follows; they and the rest of ``warmup_steps`` run in
set-up.  The window then trains from the bank, epoch after epoch, for
``--seconds``; it ends at the synchronisation after the last step it
launched, and its rate counts every image of those steps.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch

from bench_port.harness import check_train, device, frames, trace, weights
from bench_port.harness.serve import anchors_file
from bench_port.reference.model import Net


def write_dataset(traffic: dict, seed: int, dev, root: str):
    """Seeded photo-like JPEG files and their annotation lines
    (``path x1,y1,x2,y2,class ...``, image pixels)."""
    from PIL import Image
    g = frames.generator(seed, dev)
    lines = []
    n, chunk = traffic['images'], 64
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        f, boxes = frames.photo_frames(m, tuple(traffic['frame_hw']),
                                       traffic['rects'], g, dev)
        f, boxes = f.cpu().numpy(), boxes.cpu().numpy()
        for i in range(m):
            path = os.path.join(root, f'{start + i:05d}.jpg')
            Image.fromarray(f[i]).save(path, quality=traffic['jpeg_quality'])
            lines.append(path + ' ' + ' '.join(
                f'{x1:.2f},{y1:.2f},{x2:.2f},{y2:.2f},{int(c)}'
                for x1, y1, x2, y2, c in boxes[i]))
    return lines


def trainer_config(config: dict, traffic: dict, annotation: str,
                   anchors: str) -> dict:
    shape = list(config['input_shape'])
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': config['architecture'],
            'num_classes': config['num_classes'], 'input_shape': shape,
            'anchors_path': anchors}},
        'data': {'train_annotation': annotation},
        'environment': {'mixed_precision': config['mixed_precision'],
                        'remat': False},
        'data_loader': dict(traffic['data_loader']),
        'training': dict(traffic['training']),
        'optimizer': dict(traffic['optimizer']),
        'lr_schedule': dict(traffic['lr_schedule']),
    }


class Program:
    """The trainer's fused bank step and its generator, built as the
    trainer builds them, over the benchmark's lines and weights."""

    def __init__(self, config, traffic, lines, net, seed, dev, root):
        from multigriddet_tpu_torch.data import MultiGridDataGenerator
        from multigriddet_tpu_torch.training.trainer import MultiGridTrainer
        ann = os.path.join(root, 'train.txt')
        with open(ann, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        with anchors_file(config) as path:
            self.trainer = MultiGridTrainer(
                trainer_config(config, traffic, ann, path), device=dev)
            self.trainer.build_model()
        weights.load_port(self.trainer.model, net)
        tr = self.trainer
        aug = dict(tr.training_cfg.get('augmentation', {}) or {})
        max_boxes = int(aug.pop('max_boxes_per_image', 100))
        rescale = int(aug.pop('rescale_interval', -1))
        loader = tr.config['data_loader']
        self.gen = MultiGridDataGenerator(
            lines, tr.spec['anchors'], tr.spec['num_classes'],
            tuple(tr.spec['input_shape'][:2]),
            int(tr.training_cfg['batch_size']), max_boxes, aug, train=True,
            rescale_interval=rescale,
            num_workers=int(loader.get('num_workers', 8)),
            seed=check_train.seed32(seed),
            link_format=loader.get('link_format', 'auto'),
            cache_images_device=bool(loader['cache_images_device']),
            device_cache_budget=int(float(
                loader['device_cache_budget_gb']) * (1 << 30)),
            device_cache_ledger={'bytes': 0}, device=dev)
        tr.train_gen, tr.train_lines, tr.val_gen = self.gen, list(lines), None
        self.state, _, _ = tr._make_stage(0, 0)
        _, self.bank_step = tr._fused_steps
        self.batch = self.gen.batch_size

    def fill_bank(self) -> int:
        """Epoch 1 through the generator without training: every batch is
        decoded and written into the bank."""
        n = 0
        for item in self.gen.iter_raw():
            if item[0] != 'host':
                raise RuntimeError('epoch 1 found a batch already banked')
            n += 1
        return n

    def batches(self):
        """The bank's batches, epoch after epoch."""
        while True:
            for item in self.gen.iter_raw():
                if item[0] != 'bank':
                    raise RuntimeError('a batch after epoch 1 was not '
                                       'banked')
                yield item[1:]

    def step(self, item):
        banks, idx, boxes, _, g = item
        self.state, metrics = self.bank_step(self.state, banks, idx, boxes,
                                             g)
        return metrics

    def named_params(self):
        return list(self.trainer.model.named_parameters())

    def running(self):
        """Every BatchNorm's running mean and variance, in the order the
        reference's units hold them."""
        return [t for k, t in self.trainer.model.state_dict(
            keep_vars=True).items()
            if k.endswith(('running_mean', 'running_var'))]

    def first_grads(self):
        """The first update's gradient as Adam holds it: its first moment
        over ``1 - beta1``."""
        inner = self.state.optimizer.inner
        beta1 = inner.param_groups[0]['betas'][0]
        return [inner.state[p]['exp_avg'].detach().clone() / (1 - beta1)
                for _, p in self.named_params()]

    def close(self):
        self.gen.close()


def run(cell, fault=None) -> dict:
    """``fault`` (the harness's own tests and calibration only) wraps the
    step with a planted fault: see ``check_train.FAULTS``."""
    config, traffic, dev = cell.config, cell.traffic, cell.device
    spans = trace.Spans()
    cell.mark('imports')
    root = tempfile.mkdtemp(prefix='bench_port_train_')
    try:
        lines = write_dataset(traffic, cell.seed, dev, root)
        cell.mark('files')
        net = Net(config['reference'], [len(a) for a in config['anchors']],
                  config['num_classes'])
        weights.fill(net, cell.seed, dev)
        start = [t.detach().clone() for t in net.trainables()]
        prog = Program(config, traffic, lines, net, cell.seed, dev, root)
        cell.mark('trainer')
        prog.fill_bank()
        device.sync(dev)
        cell.mark('bank')
        step = check_train.planted(prog, fault)
        it = prog.batches()
        losses, grads, after, stats = [], None, None, None
        for k in range(traffic['warmup_steps']):
            metrics = step(next(it))
            if k < traffic['check_steps']:
                losses.append(metrics['loss'].detach().clone())
            if k == 0:
                grads = prog.first_grads()
            if k + 1 == traffic['check_steps']:
                after = [p.detach().clone() for _, p in prog.named_params()]
                stats = [t.detach().clone() for t in prog.running()]
        device.sync(dev)
        cell.mark('warm-up')
        setup_s = time.perf_counter() - cell.t0

        n, t_start = 0, time.perf_counter()
        while time.perf_counter() - t_start < cell.seconds:
            with spans.span('bench.wait'):
                item = next(it)
            with spans.span('bench.step'):
                step(item)
            n += 1
        device.sync(dev)
        elapsed = time.perf_counter() - t_start
        memory_peak = device.peak_bytes(dev)
        rate = n * prog.batch / elapsed
        data = {'spans': {k: list(v) for k, v in spans.durations.items()},
                'img_per_s': rate, 'window_steps': n}
        if cell.trace:
            def stretch():
                for _ in range(traffic['trace_steps']):
                    with spans.span('bench.wait'):
                        item = next(it)
                    with spans.span('bench.step'):
                        step(item)
                return traffic['trace_steps']
            data['trace'] = trace.take(stretch, spans, dev)
        names = [name for name, _ in prog.named_params()]
        program = {'losses': [float(x) for x in losses],
                   'grads': [g.cpu() for g in grads],
                   'params': [p.cpu() for p in after],
                   'stats': [t.cpu() for t in stats]}
        prog.close()
        del prog, it, step
        device.empty_cache(dev)
        numbers = check_train.compare(net, start, names, program, lines,
                                      cell.seed, config, traffic, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    e2e = {'train_img_per_s': (rate, 'img/s'), 'setup_s': (setup_s, 's')}
    return {'e2e': e2e, 'data': data, 'check': numbers,
            'attempted': n * traffic['training']['batch_size'], 'failed': 0,
            'memory_peak_bytes': memory_peak}
