"""MultiGridTrainer: two-stage, data-parallel training.

Counterpart of ``multigriddet_tpu/training/trainer.py``:

* two stages: ``transfer_epochs`` at ``freeze_level`` 1 or 2, then every
  parameter trains with a fresh optimizer;
* cosine annealing with warmup (per optimizer update, shifted by the epochs
  already trained) or reduce-on-plateau (the learning rate changes in
  place, the optimizer's moments stay), early stopping, ``nan_check``;
* EMA weights (``training.ema_decay``) validated and exported;
* checkpoints of the whole train state, ``history.jsonl``, TensorBoard when
  it is importable, ``images_per_sec``;
* resume: ``resume.weights_path`` always loads; ``resume.enabled`` gates
  only the checkpoint restore, and the epoch moves past the checkpoint
  before the stage is chosen;
* ``bn_recalibrate`` before the final ``final_model.msgpack`` (the flax
  bundle the JAX package and the port's engine both load).

Each batch goes through the fused train step (the generator's raw u8 batch
-> device stage -> train step) unless ``training.fused_input_stage`` is
false.  ``environment.distributed`` trains data parallel, one process per
GPU (``parallel/distributed.py``; ``torchrun --nproc_per_node=N``):
``training.batch_size`` is the global batch, each rank reads an equal
shard of the lines after a seeded shuffle, BatchNorm statistics, loss
normalizers, gradients and metrics are global, and only rank 0 writes
logs, checkpoints and ``final_model.msgpack``.  With
``environment.spatial_partition: sp > 1`` the ranks form a 2-D ``(dp,
sp)`` mesh as the JAX trainer builds it (``dp = world // sp``, lowered
until it divides the batch; a 1-D mesh when ``sp`` does not divide the
world): the ``sp`` ranks of a space group read the same lines and each
trains on a band of the rows of every feature map
(``parallel/spatial.py``), the batch splits over ``dp``, and the result
is one process's on the whole global batch at the whole canvas.  The
port runs every rank, so a mesh smaller than the world raises.
``environment.remat`` checkpoints the
backbone's activations (``models/detector.py``).  With ``data_loader.cache_images_device`` the
decoded images stay in a device bank (one byte budget,
``device_cache_budget_gb``, for the train and validation banks together),
and epoch 2 on trains from it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..config import (build_model_for_training, class_weights_from_config,
                      create_optimizer_from_config, make_lr_schedule,
                      resolve_learning_rate)
from ..data import MultiGridDataGenerator, load_annotation_lines
from ..device import resolve_device
from ..parallel import distributed as dist
from ..parallel.mesh import make_mesh, make_mesh_2d, replicate
from .checkpoint import CheckpointManager, model_bundle, save_params
from .state import apply_freeze, count_params, create_train_state
from .steps import make_eval_step, make_fused_train_step, make_train_step


def build_mesh(config: Dict[str, Any]):
    """The trainer's mesh, as the JAX trainer builds it
    (``multigriddet_tpu/training/trainer.py:60-78``): with
    ``environment.spatial_partition: sp > 1`` dividing the ranks, the 2-D
    ``(dp, sp)`` mesh, ``dp = world // sp`` lowered until it divides
    ``training.batch_size``; otherwise the 1-D data-parallel mesh."""
    env = config.get('environment', {}) or {}
    sp = int(env.get('spatial_partition', 1) or 1)
    world = dist.world_size()
    if sp > 1 and world % sp == 0:
        batch = int((config.get('training', {}) or {}).get('batch_size', 8))
        dp = world // sp
        while dp > 1 and batch % dp != 0:
            dp -= 1
        return make_mesh_2d(dp, sp)
    if sp > 1 and dist.is_primary():
        print(f'environment.spatial_partition={sp} does not divide the '
              f'{world} rank(s): training on the 1-D data-parallel mesh, '
              f'as the JAX trainer does')
    return make_mesh()


@contextlib.contextmanager
def swapped_params(model, params: Optional[Dict[str, torch.Tensor]]):
    """Run with ``params`` (by name) in place of the model's parameters."""
    if not params:
        yield model
        return
    live = dict(model.named_parameters())
    saved = {k: live[k].detach().clone() for k in params}
    with torch.no_grad():
        for k, v in params.items():
            live[k].copy_(v)
    try:
        yield model
    finally:
        with torch.no_grad():
            for k, v in saved.items():
                live[k].copy_(v)


class MultiGridTrainer:

    def __init__(self, config: Dict[str, Any], device=None):
        self.config = config
        env = config.get('environment', {}) or {}
        self.device = resolve_device(device)
        # multi-process: join the group before anything touches the card,
        # then train on this rank's own GPU
        dist.maybe_initialize(env.get('distributed'), self.device)
        self.device = dist.local_device(self.device)
        self.mesh = build_mesh(config)
        self.compute_dtype = (torch.bfloat16 if env.get('mixed_precision')
                              else torch.float32)
        self.training_cfg = config.get('training', {}) or {}
        self.output_cfg = config.get('output', {}) or {}
        self.callbacks_cfg = config.get('callbacks', {}) or {}
        self.history = []
        self._fused_steps = None

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def setup_data(self):
        data_cfg = self.config.get('data', {}) or {}
        aug_cfg = dict(self.training_cfg.get('augmentation', {}) or {})
        # training.batch_size is the global batch; each rank's generator
        # yields its share over the mesh's batch axis (a space group's
        # ranks read the same lines and draw alike)
        batch_size = dist.local_batch_size(
            int(self.training_cfg.get('batch_size', 8)), self.mesh)
        max_boxes = int(aug_cfg.pop('max_boxes_per_image', 100))
        rescale_interval = int(aug_cfg.pop('rescale_interval', -1))
        # multi-process: a seeded load-time shuffle, so that every rank
        # shards the same order (disjoint equal shards)
        self.train_lines = dist.shard_lines(load_annotation_lines(
            data_cfg['train_annotation'],
            seed=0 if dist.is_multiprocess() else None), self.mesh)
        val_path = data_cfg.get('val_annotation')
        self.val_lines = dist.shard_lines(
            load_annotation_lines(val_path, shuffle=False)
            if val_path and os.path.exists(val_path) else [], self.mesh)
        hw = tuple(self.spec['input_shape'][:2])
        loader_cfg = self.config.get('data_loader', {}) or {}
        workers = int(loader_cfg.get('num_workers', 8))
        disk_cache_dir = loader_cfg.get('disk_cache_dir')
        # the device image bank: one byte ledger for the train and the
        # validation caches, so the budget bounds them together
        cache_device = bool(loader_cfg.get('cache_images_device', False))
        bank = dict(cache_images_device=cache_device,
                    device_cache_budget=int(float(loader_cfg.get(
                        'device_cache_budget_gb', 4.0)) * (1 << 30)),
                    device_cache_ledger={'bytes': 0} if cache_device
                    else None)
        self.train_gen = MultiGridDataGenerator(
            self.train_lines, self.spec['anchors'], self.spec['num_classes'],
            hw, batch_size, max_boxes, aug_cfg, train=True,
            rescale_interval=rescale_interval, num_workers=workers,
            multi_anchor_assign=bool(
                self.training_cfg.get('multi_anchor_assign', False)),
            cache_images=bool(loader_cfg.get('cache_images', False)),
            disk_cache_dir=disk_cache_dir,
            link_format=loader_cfg.get('link_format', 'auto'),
            device=self.device, **bank)
        self.val_gen = MultiGridDataGenerator(
            self.val_lines, self.spec['anchors'], self.spec['num_classes'],
            hw, batch_size, max_boxes, {'enabled': False}, train=False,
            num_workers=workers, disk_cache_dir=disk_cache_dir,
            device=self.device, **bank) if self.val_lines else None

    def build_model(self, rng_seed: int = 0):
        """The detector on the device with the seeded flax-like init, then
        ``resume.weights_path`` (or only the backbone of
        ``resume.backbone_weights_path``)."""
        self.model, self.spec, self.loss_cfg = build_model_for_training(
            self.config, device=self.device, seed=rng_seed)
        replicate(self.mesh, self.model)      # rank 0's weights everywhere
        hw = tuple(self.spec['input_shape'][:2])
        if dist.is_primary():
            print(f"Model: {self.spec['architecture']}  "
              f"params: {count_params(self.model) / 1e6:.2f}M  "
              f"input: {hw}  classes: {self.spec['num_classes']}")

    # ------------------------------------------------------------------
    # stage runner
    # ------------------------------------------------------------------

    def _make_stage(self, freeze_level: int, start_epoch: int,
                    lr_override=None, ema_params=None):
        steps_per_epoch = max(len(self.train_gen), 1)
        total_epochs = int(self.training_cfg.get('epochs', 1))
        accum = int(self.training_cfg.get('gradient_accumulation', 1) or 1)
        # the schedule counts optimizer updates: one per `accum` batches
        updates_per_epoch = max(steps_per_epoch // max(accum, 1), 1)
        schedule = make_lr_schedule(self.config, updates_per_epoch,
                                    total_epochs)
        if start_epoch > 0:
            # a stage's fresh optimizer counts from 0: shift the schedule
            # by the epochs already trained
            base, offset = schedule, start_epoch * updates_per_epoch
            schedule = lambda count: base(count + offset)  # noqa: E731
        trainable = apply_freeze(self.model, freeze_level)
        sched_cfg = self.config.get('lr_schedule', {}) or {}
        if sched_cfg.get('type') == 'reduce_on_plateau':
            base_lr = lr_override or resolve_learning_rate(self.config)
            self._plateau_lr = base_lr
            opt = create_optimizer_from_config(self.config, trainable,
                                               float(base_lr), accum)
        else:
            opt = create_optimizer_from_config(self.config, trainable,
                                               schedule, accum)
        ema_decay = self.training_cfg.get('ema_decay')
        ema_decay = float(ema_decay) if ema_decay else None
        state = create_train_state(self.model, opt, ema=ema_decay is not None)
        if ema_decay is not None and ema_params is not None:
            # the EMA carries over the freeze boundary
            state.ema_params = ema_params
        cw = class_weights_from_config(
            self.config, self.spec['num_classes'], self.train_lines)
        hw = tuple(self.spec['input_shape'][:2])
        anchors, nc = self.spec['anchors'], self.spec['num_classes']
        train_step = make_train_step(anchors, nc, hw, self.loss_cfg, cw,
                                     freeze_level=freeze_level,
                                     ema_decay=ema_decay, mesh=self.mesh)
        self._fused_steps = None
        if bool(self.training_cfg.get('fused_input_stage', True)):
            self._fused_steps = make_fused_train_step(
                anchors, nc, self.loss_cfg,
                aug_cfg=self.train_gen.augment_cfg, class_weights=cw,
                freeze_level=freeze_level, ema_decay=ema_decay,
                multi_anchor_assign=self.train_gen.multi_anchor_assign,
                mesh=self.mesh)
        eval_step = make_eval_step(anchors, nc, hw, self.loss_cfg, cw,
                                   mesh=self.mesh)
        return state, train_step, eval_step

    def _train_batches(self, state, train_step):
        if self._fused_steps is not None:
            host_step, bank_step = self._fused_steps
            for item in self.train_gen.iter_raw():
                if item[0] == 'bank':
                    _, banks, idx, boxes, _, gen = item
                    yield bank_step(state, banks, idx, boxes, gen)
                else:
                    _, parts, boxes, _, gen = item
                    yield host_step(state, parts, boxes, gen)
            return
        for images, y_true, _ in self.train_gen:
            yield train_step(state, images, y_true)

    def _run_epoch(self, state, train_step, epoch: int):
        self.model.train()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        t0 = time.time()
        agg, n = {}, 0
        for state, metrics in self._train_batches(state, train_step):
            n += 1
            if (n % 50 == 0 or n == 1) and dist.is_primary():
                m = {k: float(v) for k, v in metrics.items()}
                print(f'  epoch {epoch} step {n}/{len(self.train_gen)} '
                      f"loss={m['loss']:.4f} loc={m['location']:.4f} "
                      f"obj={m['objectness']:.4f}")
            # accumulate on the device; one fetch per epoch
            for k, v in metrics.items():
                agg[k] = agg[k] + v if k in agg else v.clone()
        agg = {k: float(v) for k, v in agg.items()}
        dt = time.time() - t0
        if self.training_cfg.get('nan_check', True):
            bad = {k: v for k, v in agg.items()
                   if not torch.isfinite(torch.tensor(v))}
            if bad:
                raise FloatingPointError(
                    f'non-finite training metrics at epoch {epoch}: {bad} '
                    f'(set training.nan_check: false to disable)')
        avg = {k: v / max(n, 1) for k, v in agg.items()}
        avg['epoch_time_s'] = dt
        avg['steps'] = n
        # global images (every batch shard), not this rank's share
        bsz = self.train_gen.batch_size * self.mesh.dp
        avg['images_per_sec'] = n * bsz / dt if dt > 0 else 0.0
        return state, avg

    def _run_validation(self, state, eval_step):
        if self.val_gen is None:
            return {}
        # validate (so checkpoint and stop) on the EMA weights when they
        # are kept: they are what gets exported
        ema = (state.ema_params
               if self.training_cfg.get('ema_eval', True) else None)
        agg, n = {}, 0
        with swapped_params(self.model, ema):
            for images, y_true, _ in self.val_gen:
                metrics = eval_step(state, images, y_true)
                for k, v in metrics.items():
                    agg[k] = agg[k] + v if k in agg else v.clone()
                n += 1
        return {f'val_{k}': float(v) / max(n, 1) for k, v in agg.items()}

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def train(self):
        self.build_model()
        self.setup_data()

        model_dir = self.output_cfg.get('model_dir', 'trained_models')
        log_dir = self.output_cfg.get('log_dir', 'logs/training')
        os.makedirs(model_dir, exist_ok=True)
        os.makedirs(log_dir, exist_ok=True)
        tb_cfg = self.callbacks_cfg.get('tensorboard', {}) or {}
        tb_writer = None
        primary = dist.is_primary()     # rank 0 owns every file written
        if tb_cfg and primary:
            try:
                from torch.utils.tensorboard import SummaryWriter
                tb_writer = SummaryWriter(tb_cfg.get(
                    'log_dir', os.path.join(log_dir, 'tensorboard')))
            except ImportError:
                pass
        ckpt_cfg = self.callbacks_cfg.get('checkpoint', {}) or {}
        ckpt = CheckpointManager(
            ckpt_cfg.get('save_dir', os.path.join(log_dir, 'checkpoints')),
            monitor=ckpt_cfg.get('monitor', 'val_loss'),
            save_best_only=bool(ckpt_cfg.get('save_best_only', False)))
        es_cfg = self.callbacks_cfg.get('early_stopping', {}) or {}
        es_patience = int(es_cfg.get('patience', 0) or 0)
        sched_cfg = self.config.get('lr_schedule', {}) or {}

        epochs = int(self.training_cfg.get('epochs', 1))
        initial_epoch = int(self.training_cfg.get('initial_epoch', 0))
        transfer_epochs = int(self.training_cfg.get('transfer_epochs', 0))
        freeze_level = int(self.training_cfg.get('freeze_level', 0))

        ema_params = None
        best_val = float('inf')
        patience_count = 0
        plateau_patience = int(sched_cfg.get('patience', 3))
        plateau_factor = float(sched_cfg.get('factor', 0.5))
        plateau_count = 0
        epoch = initial_epoch

        stages = []
        if transfer_epochs > initial_epoch and freeze_level > 0:
            stages.append((freeze_level, transfer_epochs))
        stages.append((0, epochs))

        resume = self.config.get('resume', {}) or {}
        restore_state = (bool(resume.get('enabled'))
                         and ckpt.latest_step() is not None)
        if restore_state:
            # checkpoints are keyed by the epoch they completed: move past
            # it BEFORE choosing the stage
            epoch = max(epoch, int(ckpt.latest_step()) + 1)

        state = None
        for stage_idx, (fl, until_epoch) in enumerate(stages):
            if epoch >= until_epoch:
                continue
            lr_override = getattr(self, '_plateau_lr', None)
            state, train_step, eval_step = self._make_stage(
                fl, epoch, lr_override, ema_params)
            if restore_state:
                state = ckpt.restore(state, allow_mismatch=True)
                epoch = max(epoch, state.step // max(len(self.train_gen), 1))
                restore_state = False
                print(f'Resumed from checkpoint at epoch {epoch}')
            print(f'--- stage {stage_idx + 1}: freeze_level={fl}, '
                  f'epochs {epoch} -> {until_epoch} ---')
            while epoch < until_epoch:
                state, train_m = self._run_epoch(state, train_step, epoch)
                val_m = self._run_validation(state, eval_step)
                record = {'epoch': epoch, **train_m, **val_m}
                self.history.append(record)
                if primary:
                    with open(os.path.join(log_dir, 'history.jsonl'),
                              'a') as f:
                        f.write(json.dumps(record) + '\n')
                if tb_writer is not None:
                    for k, v in record.items():
                        if isinstance(v, (int, float)):
                            tb_writer.add_scalar(k, v, epoch)
                    tb_writer.flush()
                # the metrics are global, so every rank takes the same
                # checkpoint, stopping and plateau decisions
                monitor = val_m.get('val_loss', train_m.get('loss', 0.0))
                if primary:
                    print(f"epoch {epoch}: "
                          f"loss={train_m.get('loss', 0):.4f} val_loss="
                          f"{val_m.get('val_loss', float('nan')):.4f} "
                          f"({train_m.get('images_per_sec', 0):.1f} img/s)")
                save_freq = int(self.output_cfg.get('save_frequency', 1)
                                or 1)
                if primary and (epoch % save_freq == 0
                                or epoch + 1 == until_epoch):
                    ckpt.save(epoch, state,
                              {'val_loss': monitor,
                               **{k: v for k, v in train_m.items()
                                  if k == 'loss'}})
                # early stopping / plateau bookkeeping
                if monitor < best_val - 1e-6:
                    best_val = monitor
                    patience_count = 0
                    plateau_count = 0
                else:
                    patience_count += 1
                    plateau_count += 1
                    if (sched_cfg.get('type') == 'reduce_on_plateau'
                            and plateau_count >= plateau_patience):
                        self._plateau_lr = max(
                            getattr(self, '_plateau_lr',
                                    resolve_learning_rate(self.config))
                            * plateau_factor,
                            float(sched_cfg.get('min_lr', 1e-7)))
                        print(f'Reducing LR to {self._plateau_lr:.2e}')
                        plateau_count = 0
                        # in place: the optimizer's moments stay
                        state.optimizer.set_lr(self._plateau_lr)
                if es_patience and patience_count >= es_patience:
                    print(f'Early stopping at epoch {epoch} '
                          f'(no improvement for {es_patience} epochs)')
                    epoch += 1
                    break
                epoch += 1
            ema_params = state.ema_params
            if es_patience and patience_count >= es_patience:
                break

        if restore_state:
            # every epoch was trained before the resume: export the
            # checkpointed weights, not the fresh init
            raw = ckpt.restore_raw()
            self.model.load_state_dict(raw['model'])
            ema_params = raw.get('ema_params')
            print('Resume found training already complete; exporting the '
                  'checkpointed weights')

        if ema_params:
            print('Exporting EMA-averaged weights '
                  f"(decay={self.training_cfg.get('ema_decay')})")
            with torch.no_grad():
                live = dict(self.model.named_parameters())
                for k, v in ema_params.items():
                    live[k].copy_(v)

        if self.training_cfg.get('bn_recalibrate', False):
            # running statistics lag the weights on short schedules:
            # recompute them over a sweep of training batches
            from .calibrate import calibrate_batch_stats
            n_cal = int(self.training_cfg.get('bn_recalibrate_batches', 32))
            calibrate_batch_stats(self.model, iter(self.train_gen),
                                  max_batches=n_cal, mesh=self.mesh)
            print(f'Recalibrated BN statistics over {n_cal} batches')

        final_path = os.path.join(model_dir, 'final_model.msgpack')
        if primary:
            # the replicas are equal: rank 0 holds the whole model
            save_params(final_path, model_bundle(self.model))
            print(f'Saved final model to {final_path}')
        if tb_writer is not None:
            tb_writer.close()
        ckpt.close()
        self.model.eval()
        return self.history
