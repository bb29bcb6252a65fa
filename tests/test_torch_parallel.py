"""Data-parallel training of the port: one process per device under
``torch.distributed`` (gloo on the CPU).

* **Two ranks against one process.**  ``multigriddet_tiny`` at 64x64, a
  global batch of 4 (2 a rank), augmentation off, two SGD steps from the
  same weights: the two ranks' loss terms (summed over the ranks by the
  step), running statistics and parameters against one process on the
  concatenated batch, within 1e-10 (of max(1, |value|)) in float64 and
  1e-5 in float32.  The float32 run is also held against the JAX step on
  a 2-device mesh of the 8-device CPU platform (``tests/conftest.py``):
  loss terms and running statistics within 1e-4 relative.
* **A two-process ``MultiGridTrainer.train()``** (8 lines, 2 epochs, a
  frozen first stage, augmentation and ``bn_recalibrate`` on): equal
  losses on both ranks, ``history.jsonl`` with one line an epoch,
  ``final_model.msgpack`` written by rank 0 alone.
* The single-process helpers, the meshes' shapes, and a one-process
  trainer with ``environment.spatial_partition: 2`` falling back to the
  1-D mesh, as the JAX trainer does (``tests/test_torch_spatial.py`` holds
  the spatial partitioning itself).

The ranks are this file run as a script (no JAX imported there), each
with a timeout and a free port, so a hang fails the test instead of the
suite.  ``--noconftest -m cuda`` on the card runs the gloo ranks on CUDA
tensors (JAX is imported inside the tests that use it).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from multigriddet_tpu_torch.losses import LossConfig  # noqa: E402
from multigriddet_tpu_torch.models import (create_model,  # noqa: E402
                                           load_flax_variables,
                                           random_flax_variables)
from multigriddet_tpu_torch.ops.encoding import encode_targets  # noqa: E402
from multigriddet_tpu_torch.parallel import (  # noqa: E402
    is_multiprocess, is_primary, local_batch_size, make_mesh, make_mesh_2d,
    image_partition_spec, maybe_initialize, replicate, shard_batch,
    shard_lines, world_size)
from multigriddet_tpu_torch.training import (TrainOptimizer,  # noqa: E402
                                             create_train_state,
                                             make_train_step)

HW = (64, 64)
NC = 3
GLOBAL_BATCH = 4
LR = 1e-2
ANCHORS = [np.array([[40, 40], [30, 50], [50, 30]], np.float32),
           np.array([[20, 20], [14, 28], [28, 14]], np.float32),
           np.array([[10, 10], [7, 14], [14, 7]], np.float32)]
# the loss block of configs/train_config.yaml, with the per-positive
# normalizer on top of the batch one, so every global normalizer is used
LOSS = dict(coord_scale=5.0, no_object_scale=0.5, label_smoothing=0.01,
            use_consensus_loss=True, max_gt_boxes=16,
            loss_normalization=('batch', 'positives'))
TIMEOUT = 240


# ---------------------------------------------------------------------------
# the step, as each rank and the single process run it
# ---------------------------------------------------------------------------

def _batch(step):
    rng = np.random.RandomState(20 + step)
    boxes = np.zeros((GLOBAL_BATCH, 6, 5), np.float32)
    for b in range(GLOBAL_BATCH):
        for t in range(rng.randint(2, 6)):
            w, h = rng.uniform(6, 40), rng.uniform(6, 40)
            x, y = rng.uniform(0, HW[1] - w), rng.uniform(0, HW[0] - h)
            boxes[b, t] = [x, y, x + w, y + h, rng.randint(NC)]
    images = rng.randint(0, 256, (GLOBAL_BATCH, *HW, 3)).astype(
        np.float32) / 255.0
    return images, boxes


def run_steps(dtype, device='cpu', steps=2):
    """Two SGD steps of ``multigriddet_tiny`` on this process's share of
    each global batch (all of it single-process).  Returns the per-step
    metrics and the final parameters and running statistics."""
    torch.manual_seed(0)
    model = create_model('multigriddet_tiny', num_classes=NC, dtype=dtype)
    load_flax_variables(model, *random_flax_variables(model, seed=4))
    model = model.to(device=device, dtype=dtype).train()
    mesh = make_mesh()
    replicate(mesh, model)
    opt = TrainOptimizer(torch.optim.SGD(model.parameters(), lr=LR))
    state = create_train_state(model, opt)
    step = make_train_step(ANCHORS, NC, HW, LossConfig(**LOSS))
    metrics = []
    for i in range(steps):
        images, boxes = _batch(i)
        y_true = encode_targets(torch.from_numpy(boxes), ANCHORS, NC, HW)
        images, *y_true = shard_batch(mesh, torch.from_numpy(images),
                                      *y_true)
        state, m = step(state, images.to(device, dtype),
                        [y.to(device, dtype) for y in y_true])
        metrics.append({k: float(v) for k, v in m.items()})
    final = {k: v.detach().cpu().double()
             for k, v in model.state_dict().items()
             if not k.endswith('num_batches_tracked')}
    return metrics, final


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _launch(mode, out_dir, *extra, world=2):
    """``world`` ranks of this file in ``mode``, each awaited with a
    timeout; returns their outputs."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get('PYTHONPATH', ''), OMP_NUM_THREADS='2')
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank),
         str(world), str(port), str(out_dir), *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f'rank failed:\n{out[-4000:]}'
    return outs


def _dist_cfg(rank, world, port):
    return {'enabled': True, 'coordinator_address': f'localhost:{port}',
            'num_processes': world, 'process_id': rank}


def _worker_steps(rank, world, port, out_dir, dtype, device):
    # gloo on CUDA tensors too (two ranks share one card, which NCCL
    # refuses); maybe_initialize then finds the group and keeps it
    torch.distributed.init_process_group(
        'gloo', init_method=f'tcp://localhost:{port}', world_size=world,
        rank=rank)
    assert maybe_initialize(_dist_cfg(rank, world, port),
                            torch.device(device))
    assert world_size() == world and is_multiprocess()
    metrics, final = run_steps(getattr(torch, dtype), device)
    torch.save({'metrics': metrics, 'final': final},
               os.path.join(out_dir, f'rank{rank}.pt'))


def _worker_trainer(rank, world, port, out_dir, root):
    from multigriddet_tpu_torch.training import trainer as trainer_mod
    writes = []
    save = trainer_mod.save_params
    trainer_mod.save_params = lambda *a: (writes.append(a[0]), save(*a))
    config = _trainer_config(root, out_dir)
    config['environment'] = {'distributed': _dist_cfg(rank, world, port)}
    trainer = trainer_mod.MultiGridTrainer(config, device='cpu')
    history = trainer.train()
    out = {'rank': rank, 'world': world_size(),
           'primary': is_primary(),
           'local_batch': trainer.train_gen.batch_size,
           'train_lines': trainer.train_lines,
           'losses': [h['loss'] for h in history],
           'val_losses': [h['val_loss'] for h in history],
           'steps': [h['steps'] for h in history],
           'final_writes': writes}
    with open(os.path.join(out_dir, f'result_{rank}.json'), 'w') as f:
        json.dump(out, f)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f'{what}: {err:.3e} > {rtol}'


def _assert_runs_close(dp, single, rtol):
    (m_dp, f_dp), (m_one, f_one) = dp, single
    for a, b in zip(m_dp, m_one):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], rtol, f'metric {k}')
    assert set(f_dp) == set(f_one)
    for k in f_one:
        _close(f_dp[k], f_one[k], rtol, k)


def _two_ranks(tmp_path, dtype, device='cpu'):
    _launch('steps', tmp_path, dtype, device)
    ranks = [torch.load(tmp_path / f'rank{r}.pt') for r in range(2)]
    # every rank holds the same replica and reports the global metrics
    for k, v in ranks[0]['final'].items():
        assert torch.equal(v, ranks[1]['final'][k]), k
    assert ranks[0]['metrics'] == ranks[1]['metrics']
    return ranks[0]['metrics'], ranks[0]['final']


@pytest.mark.parametrize('dtype,rtol', [('float64', 1e-10),
                                        ('float32', 1e-5)])
def test_two_ranks_equal_one_process_on_the_whole_batch(tmp_path, dtype,
                                                        rtol):
    dp = _two_ranks(tmp_path, dtype)
    single = run_steps(getattr(torch, dtype))
    assert dp[0][0]['num_positives'] == single[0][0]['num_positives'] > 0
    _assert_runs_close(dp, single, rtol)
    if dtype == 'float32':
        _assert_close_to_jax_mesh(dp)


def _assert_close_to_jax_mesh(dp):
    """The JAX step on a 2-device mesh from the same weights and global
    batches: loss terms and running statistics within 1e-4 relative."""
    import jax
    import jax.numpy as jnp
    import optax
    from multigriddet_tpu.losses import LossConfig as JLossConfig
    from multigriddet_tpu.models import create_model as jax_create_model
    from multigriddet_tpu.ops.encoding import encode_targets as jax_encode
    from multigriddet_tpu.training import state as jstate_mod
    from multigriddet_tpu.training import steps as jsteps
    from multigriddet_tpu_torch.models import flax_to_state_dict
    jmodel = jax_create_model('multigriddet_tiny', num_classes=NC)
    params, stats = random_flax_variables(
        create_model('multigriddet_tiny', num_classes=NC), seed=4)
    mesh = jsteps.make_mesh(jax.devices()[:2])
    tx = optax.sgd(LR)
    state = jstate_mod.create_train_state(params, stats, tx)
    state = jsteps.replicate(mesh, state)
    step = jsteps.make_train_step(jmodel, tx, ANCHORS, NC, HW,
                                  JLossConfig(**LOSS), mesh=mesh,
                                  donate=False)
    for i, want in enumerate(dp[0]):
        images, boxes = _batch(i)
        y_true = [np.asarray(y) for y in jax_encode(boxes, ANCHORS, NC, HW)]
        state, m = step(state, jnp.asarray(images), y_true)
        for k in m:
            _close(want[k], float(m[k]), 1e-4, f'step {i} {k} vs JAX')
    jstats = flax_to_state_dict({}, jax.tree_util.tree_map(
        np.asarray, state.batch_stats))
    for k, v in jstats.items():
        _close(dp[1][k], v, 1e-4, f'{k} vs JAX')


# ---------------------------------------------------------------------------
# the trainer across two processes
# ---------------------------------------------------------------------------

def _dataset(root):
    from PIL import Image, ImageDraw
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
        p = os.path.join(root, f'img_{i}.jpg')
        img.save(p)
        lines.append(f'{p} {x1},{y1},{x2},{y2},{cls}')
    with open(os.path.join(root, 'train.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    with open(os.path.join(root, 'classes.txt'), 'w') as f:
        f.write('red\ngreen\n')
    with open(os.path.join(root, 'anchors.txt'), 'w') as f:
        f.write('40,40\n20,20\n10,10\n')


def _trainer_config(root, out):
    j = os.path.join
    return {
        'model': {'type': 'preset', 'preset': {
            'architecture': 'multigriddet_tiny', 'num_classes': 2,
            'input_shape': [*HW, 3], 'anchors_path': j(root, 'anchors.txt'),
            'classes_path': j(root, 'classes.txt')}},
        'data': {'train_annotation': j(root, 'train.txt'),
                 'val_annotation': j(root, 'train.txt')},
        'data_loader': {'num_workers': 1},
        'training': {
            'batch_size': GLOBAL_BATCH, 'epochs': 2, 'transfer_epochs': 1,
            'freeze_level': 1, 'learning_rate': 1e-3, 'loss_option': 2,
            'bn_recalibrate': True, 'bn_recalibrate_batches': 2,
            'augmentation': {'enabled': True, 'mosaic_prob': 0.3,
                             'mixup_prob': 0.1, 'max_boxes_per_image': 10}},
        'optimizer': {'type': 'adam'},
        'lr_schedule': {'type': 'cosine_annealing', 'warmup_epochs': 1},
        'callbacks': {'checkpoint': {'save_dir': j(out, 'ckpt')}},
        'output': {'log_dir': j(out, 'logs'), 'model_dir': j(out, 'models')},
    }


def test_two_process_trainer(tmp_path):
    root = tmp_path / 'data'
    root.mkdir()
    _dataset(str(root))
    _launch('trainer', tmp_path, str(root))
    r0, r1 = [json.loads((tmp_path / f'result_{r}.json').read_text())
              for r in range(2)]
    assert r0['world'] == r1['world'] == 2
    assert (r0['primary'], r1['primary']) == (True, False)
    # global batch 4 -> 2 a rank; 8 lines -> 4 a rank -> 2 steps an epoch
    assert r0['local_batch'] == r1['local_batch'] == 2
    assert len(r0['train_lines']) == len(r1['train_lines']) == 4
    assert not set(r0['train_lines']) & set(r1['train_lines'])
    assert r0['steps'] == r1['steps'] == [2, 2]
    # the metrics are global: every rank reports the same losses
    assert r0['losses'] == r1['losses']
    assert r0['val_losses'] == r1['val_losses']
    assert all(np.isfinite(r0['losses'] + r0['val_losses']))
    # one writer
    final = str(tmp_path / 'models' / 'final_model.msgpack')
    assert (r0['final_writes'], r1['final_writes']) == ([final], [])
    assert os.path.exists(final)
    hist = (tmp_path / 'logs' / 'history.jsonl').read_text().splitlines()
    assert [json.loads(h)['epoch'] for h in hist] == [0, 1]


# ---------------------------------------------------------------------------
# single process
# ---------------------------------------------------------------------------

def test_single_process_helpers():
    assert not is_multiprocess() and is_primary() and world_size() == 1
    assert maybe_initialize(None) is False
    assert maybe_initialize({}) is False
    assert maybe_initialize({'enabled': 'auto'}) is False
    assert maybe_initialize({'enabled': False,
                             'coordinator_address': 'x:1'}) is False
    lines = [f'l{i}' for i in range(10)]
    assert shard_lines(lines) == lines
    assert local_batch_size(32) == 32
    mesh = make_mesh()
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {'batch': 1})
    x = torch.arange(12.).reshape(4, 3)
    assert torch.equal(shard_batch(mesh, x)[0], x)
    assert replicate(mesh, x) is x
    # the 2-D mesh of one rank, and the placements of both meshes
    mesh2 = make_mesh_2d(1, 1)
    assert (mesh2.size, mesh2.rank, mesh2.shape) == (
        1, 0, {'batch': 1, 'space': 1})
    assert image_partition_spec(mesh) == ('batch',)
    assert image_partition_spec(mesh2) == ('batch', 'space')
    assert torch.equal(shard_batch(mesh2, x)[0], x)
    with pytest.raises(ValueError, match='needs 4 ranks'):
        make_mesh_2d(2, 2)


def test_spatial_partition_still_raises(tmp_path):
    """Named for what it held before spatial partitioning was ported: a
    one-process trainer with ``spatial_partition: 2`` (which does not
    divide its one rank) now builds the 1-D mesh, as the JAX trainer does,
    and trains."""
    from multigriddet_tpu_torch.training import MultiGridTrainer
    root = tmp_path / 'data'
    root.mkdir()
    _dataset(str(root))
    cfg = _trainer_config(str(root), str(tmp_path))
    cfg['environment'] = {'spatial_partition': 2}
    cfg['training'].update(epochs=1, transfer_epochs=0, bn_recalibrate=False)
    trainer = MultiGridTrainer(cfg, device='cpu')
    assert trainer.mesh.shape == {'batch': 1}
    history = trainer.train()
    assert len(history) == 1 and np.isfinite(history[0]['loss'])


@pytest.mark.cuda
def test_two_gloo_ranks_on_cuda_tensors(tmp_path):
    """On the card: the two ranks on one GPU (gloo on CUDA tensors, TF32
    off) against one process on the whole batch, float32 within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU; run with -m cuda on the card')
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dp = _two_ranks(tmp_path, 'float32', 'cuda')
        single = run_steps(torch.float32, 'cuda')
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    _assert_runs_close(dp, single, 1e-5)


if __name__ == '__main__':
    mode, rank, world, port, out_dir, *rest = sys.argv[1:]
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == 'steps':
        _worker_steps(int(rank), int(world), int(port), out_dir, *rest)
    else:
        _worker_trainer(int(rank), int(world), int(port), out_dir, *rest)
    torch.distributed.destroy_process_group()
